"""A document tree from the standard library's ``html.parser``, built by
Beautiful Soup's ``html.parser`` tree-builder rules, with the CSS selectors
the AbeBooks provider uses.

The JAX package's AbeBooks provider parses result pages with
``BeautifulSoup(html, "html.parser")`` and soupsieve selectors; the port
runs where ``bs4`` is missing, so it builds the same tree from the same
parser events and answers the same queries. The rules, as bs4 4.x applies
them:

- no end tag is implied: an unclosed ``<li>`` or ``<p>`` holds everything
  up to an end tag that closes one of its ancestors;
- an end tag closes the most recent open element of its name and every
  element opened after it; with none of its name open it closes nothing;
- void elements (``br``, ``img``, ``meta``, ...) close at once, and the next
  end tag of the same name is dropped; ``<x/>`` opens and closes ``x``;
- a valueless attribute is ``""`` and the last of duplicates wins; the
  multi-valued attributes (``class``, ``rel``, ...) are split on whitespace;
- adjacent text, character references included, is one string, ended by
  the next start tag, end tag (but a dropped one), comment or declaration;
  named references bs4 knows become their characters, unknown ones stay
  ``&name``; numeric ones follow the HTML spec (C1 controls as
  windows-1252); whitespace-only strings outside ``pre``/``textarea``
  become one space or newline;
- comments, declarations, doctypes, processing instructions, and text in
  ``script``, ``style``, ``template``, ``rt`` and ``rp`` are strings of
  other kinds, which ``get_text`` of any other element leaves out.

Selectors: type, ``*``, class and compound selectors, the descendant
combinator, comma groups, and ``[a]``, ``[a='v']``, ``[a*='v']`` and
``[a^='v']`` matched as soupsieve matches them (the tree's whole ancestry
for a descendant combinator; names without case; document order, each
element once). Anything else raises ``ValueError``.
"""

from __future__ import annotations

import html.entities
import re
from html.parser import HTMLParser
from typing import Dict, Iterator, List, Optional, Tuple, Union

VOID_ELEMENTS = frozenset({
    "area", "base", "br", "col", "embed", "hr", "img", "input", "keygen", "link", "menuitem", "meta",
    "param", "source", "track", "wbr", "basefont", "bgsound", "command", "frame", "image", "isindex",
    "nextid", "spacer",
})
# Elements whose text is a string of their own kind
STRING_CONTAINERS = frozenset({"rt", "rp", "style", "script", "template"})
PRESERVE_WHITESPACE = frozenset({"pre", "textarea"})
# Attributes whose value is a whitespace-separated list: for every element,
# and per element name
LIST_ATTRIBUTES = frozenset({"class", "accesskey", "dropzone"})
LIST_ATTRIBUTES_OF = {
    "a": {"rel", "rev"}, "link": {"rel", "rev"}, "td": {"headers"}, "th": {"headers"},
    "form": {"accept-charset"}, "object": {"archive"}, "area": {"rel"}, "icon": {"sizes"},
    "iframe": {"sandbox"}, "output": {"for"},
}
_ASCII_SPACES = "\x20\x0a\x09\x0c\x0d"
_NON_WHITESPACE = re.compile(r"\S+")
_DECIMAL_WITH_DATA = re.compile("^([0-9]+)(.*)")
_HEX_WITH_DATA = re.compile("^([0-9a-f]+)(.*)")
_NONCHARACTERS = frozenset({0xFFFE, 0xFFFF} | {p * 0x10000 + x for p in range(1, 17) for x in (0xFFFE, 0xFFFF)})


def _entities() -> Dict[str, str]:
    """Entity name (without ';') -> characters, the first of the sorted
    HTML5 table winning, as bs4 builds it."""
    out: Dict[str, str] = {}
    for key, chars in sorted(html.entities.html5.items()):
        out.setdefault(key[:-1] if key.endswith(";") else key, chars)
    return out


ENTITIES = _entities()


def numeric_reference(name: str) -> Tuple[str, str]:
    """A numeric character reference as ``html.parser`` passes it (``"65"``,
    ``"x41"``) -> (its character, the text after the number)."""
    base, pattern = 10, _DECIMAL_WITH_DATA
    if name[:1] in ("x", "X"):
        name, base, pattern = name[1:], 16, _HEX_WITH_DATA
    extra = ""
    try:
        number = int(name, base)
    except ValueError:
        m = pattern.search(name)
        if m is None:
            return "", name
        number, extra = int(m.group(1), base), m.group(2)
    if number == 0 or number > 0x10FFFF or 0xD800 <= number <= 0xDFFF:
        return "\ufffd", extra
    if 0xFDD0 <= number <= 0xFDEF or number in _NONCHARACTERS:
        return chr(number), extra
    if 0x80 <= number <= 0x9F:
        try:
            return bytes([number]).decode("cp1252"), extra
        except UnicodeDecodeError:
            pass
    return chr(number), extra


class Text:
    """A string of the tree: ``kind`` is ``"text"`` (bs4's
    ``NavigableString``), ``"cdata"``, ``"comment"``, ``"doctype"``,
    ``"declaration"``, ``"pi"`` or the name of its string container
    (``"script"``, ...)."""

    __slots__ = ("value", "kind", "parent")

    def __init__(self, value: str, kind: str, parent: "Element"):
        self.value, self.kind, self.parent = value, kind, parent


class Element:
    """An element of the tree, with bs4's ``Tag`` queries the AbeBooks
    provider uses. Always true, as a bs4 ``Tag`` is."""

    __slots__ = ("name", "attrs", "children", "parent")

    def __init__(self, name: str, attrs: Dict[str, str], parent: Optional["Element"]):
        self.name, self.attrs, self.children, self.parent = name, attrs, [], parent

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return f"<Element {self.name} {self.attrs}>"

    def get(self, key: str, default=None) -> Union[str, List[str], None]:
        """The attribute's value: a list of its words for a multi-valued
        attribute (``class``), as bs4 gives it."""
        if key not in self.attrs:
            return default
        if key in LIST_ATTRIBUTES or key in LIST_ATTRIBUTES_OF.get(self.name, ()):
            return _NON_WHITESPACE.findall(self.attrs[key])
        return self.attrs[key]

    def has_attr(self, key: str) -> bool:
        return key in self.attrs

    def descendants(self) -> Iterator[Union["Element", Text]]:
        """Every node below this one, in document order."""
        stack = list(reversed(self.children))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, Element):
                stack.extend(reversed(node.children))

    def strings(self, strip: bool = False) -> Iterator[str]:
        """The strings ``get_text`` joins: text (and CDATA) below this
        element, or for a string container its own kind only."""
        kinds = (self.name,) if self.name in STRING_CONTAINERS else ("text", "cdata")
        for node in self.descendants():
            if isinstance(node, Text) and node.kind in kinds:
                value = node.value.strip() if strip else node.value
                if value:
                    yield value

    def get_text(self, separator: str = "", strip: bool = False) -> str:
        return separator.join(self.strings(strip))

    def select(self, selector: str) -> List["Element"]:
        """The descendants that match ``selector``, in document order."""
        groups = parse_selector(selector)
        return [el for el in self.descendants() if isinstance(el, Element) and _matches_any(el, groups)]

    def select_one(self, selector: str) -> Optional["Element"]:
        groups = parse_selector(selector)
        for el in self.descendants():
            if isinstance(el, Element) and _matches_any(el, groups):
                return el
        return None

    def find(self, name: str) -> Optional["Element"]:
        """The first descendant element called ``name``."""
        for el in self.descendants():
            if isinstance(el, Element) and el.name == name:
                return el
        return None


class _TreeBuilder(HTMLParser):
    """``html.parser`` events -> the tree, by bs4's rules (its
    ``BeautifulSoupHTMLParser`` and ``BeautifulSoup`` tree methods)."""

    def __init__(self):
        super().__init__(convert_charrefs=False)
        self.root = Element("[document]", {}, None)
        self.stack: List[Element] = [self.root]
        self.data: List[str] = []
        self.closed_void: List[str] = []

    # -- bs4's BeautifulSoup: text runs and the open-element stack --------

    def _end_data(self, kind: str = "text") -> None:
        if not self.data:
            return
        value = "".join(self.data)
        self.data = []
        if not any(el.name in PRESERVE_WHITESPACE for el in self.stack[1:]) and all(
                c in _ASCII_SPACES for c in value):
            value = "\n" if "\n" in value else " "
        if kind == "text":
            containers = [el.name for el in self.stack if el.name in STRING_CONTAINERS]
            if containers:
                kind = containers[-1]
        parent = self.stack[-1]
        parent.children.append(Text(value, kind, parent))

    def _open(self, name: str, attrs: Dict[str, str]) -> Element:
        self._end_data()
        el = Element(name, attrs, self.stack[-1])
        self.stack[-1].children.append(el)
        self.stack.append(el)
        return el

    def _close(self, name: str) -> None:
        self._end_data()
        for i in range(len(self.stack) - 1, 0, -1):
            if self.stack[i].name == name:
                del self.stack[i:]
                return

    # -- bs4's BeautifulSoupHTMLParser -----------------------------------

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs, void=False)
        self._close(tag)

    def handle_starttag(self, tag, attrs, void=True):
        values: Dict[str, str] = {}
        for key, value in attrs:
            values[key] = "" if value is None else value
        el = self._open(tag, values)
        if void and tag in VOID_ELEMENTS and not el.children:
            self._close(tag)
            self.closed_void.append(tag)

    def handle_endtag(self, tag):
        if tag in self.closed_void:
            self.closed_void.remove(tag)
        else:
            self._close(tag)

    def handle_data(self, data):
        self.data.append(data)

    def handle_charref(self, name):
        char, extra = numeric_reference(name)
        self.data += [char, extra]

    def handle_entityref(self, name):
        self.data.append(ENTITIES.get(name, f"&{name}"))

    def _other(self, data: str, kind: str) -> None:
        self._end_data()
        self.data.append(data)
        self._end_data(kind)

    def handle_comment(self, data):
        self._other(data, "comment")

    def handle_decl(self, decl):
        self._other(decl[len("DOCTYPE "):], "doctype")

    def unknown_decl(self, data):
        if data.upper().startswith("CDATA["):
            self._other(data[len("CDATA["):], "cdata")
        else:
            self._other(data, "declaration")

    def handle_pi(self, data):
        self._other(data, "pi")


def parse_html(markup: str) -> Element:
    """The document's root (bs4's ``BeautifulSoup`` object)."""
    builder = _TreeBuilder()
    builder.feed(markup)
    builder.close()
    builder._end_data()
    return builder.root


# ---------------------------------------------------------------------------
# Selectors
# ---------------------------------------------------------------------------

_SELECTOR_TOKEN = re.compile(r"""
    (?P<space>\s+)
  | (?P<comma>,)
  | (?P<type>\*|[A-Za-z][-\w]*)
  | (?P<cls>\.[-\w]+)
  | \[\s*(?P<attr>[-\w]+)\s*(?:(?P<op>[*^]?=)\s*(?:'(?P<sq>[^'\\]*)'|"(?P<dq>[^"\\]*)"|(?P<bare>[-\w]+))\s*)?\]
""", re.X)


class _Compound:
    __slots__ = ("name", "classes", "attrs")

    def __init__(self):
        self.name: Optional[str] = None
        self.classes: List[str] = []
        self.attrs: List[Tuple[str, Optional[re.Pattern]]] = []

    def matches(self, el: Element) -> bool:
        if self.name is not None and self.name != "*" and el.name.lower() != self.name:
            return False
        if self.classes:
            have = _NON_WHITESPACE.findall(el.attrs.get("class", ""))
            if any(c not in have for c in self.classes):
                return False
        for name, pattern in self.attrs:
            value = next((v for k, v in el.attrs.items() if k.lower() == name), None)
            if value is None:
                return False
            if name in LIST_ATTRIBUTES or name in LIST_ATTRIBUTES_OF.get(el.name, ()):
                value = " ".join(_NON_WHITESPACE.findall(value))
            if pattern is not None and pattern.match(value) is None:
                return False
        return True


def _attribute_pattern(op: Optional[str], value: str) -> Optional[re.Pattern]:
    """soupsieve's pattern for ``[a op 'value']``."""
    if op is None:
        return None
    escaped = re.escape(value) if value else r"(?!)"
    if op == "^=":
        return re.compile(r"^%s.*" % escaped, re.DOTALL)
    if op == "*=":
        return re.compile(r".*?%s.*" % escaped, re.DOTALL)
    return re.compile(r"^%s$" % re.escape(value), re.DOTALL)


def parse_selector(selector: str) -> List[List[_Compound]]:
    """``"a.b .c, d"`` -> groups of compounds, each group's last compound
    the element's own."""
    groups: List[List[_Compound]] = [[]]
    current: Optional[_Compound] = None
    pos = 0
    while pos < len(selector):
        m = _SELECTOR_TOKEN.match(selector, pos)
        if m is None:
            raise ValueError(f"unsupported selector {selector!r} at {pos}")
        pos = m.end()
        if m.group("space"):
            current = None
            continue
        if m.group("comma"):
            if not groups[-1]:
                raise ValueError(f"empty group in selector {selector!r}")
            groups.append([])
            current = None
            continue
        if current is None:
            current = _Compound()
            groups[-1].append(current)
        if m.group("type"):
            if current.name is not None or current.classes or current.attrs:
                raise ValueError(f"misplaced type in selector {selector!r}")
            current.name = m.group("type").lower()
        elif m.group("cls"):
            current.classes.append(m.group("cls")[1:])
        else:
            value = next((m.group(g) for g in ("sq", "dq", "bare") if m.group(g) is not None), "")
            current.attrs.append((m.group("attr").lower(), _attribute_pattern(m.group("op"), value)))
    if any(not group for group in groups):
        raise ValueError(f"empty group in selector {selector!r}")
    return groups


def _matches(el: Element, compounds: List[_Compound], i: int) -> bool:
    if not compounds[i].matches(el):
        return False
    if i == 0:
        return True
    parent = el.parent
    while parent is not None and parent.parent is not None:  # the document root matches nothing
        if _matches(parent, compounds, i - 1):
            return True
        parent = parent.parent
    return False


def _matches_any(el: Element, groups: List[List[_Compound]]) -> bool:
    return any(_matches(el, group, len(group) - 1) for group in groups)
