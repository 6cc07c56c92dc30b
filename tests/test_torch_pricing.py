"""The port's pricing layer against the JAX package's, on the CPU.

- ``parse`` and ``select`` on the same inputs (hypothesis for the string
  parsers), the stub providers, Google Books on the recorded payload of
  ``tests/test_google_books.py`` and ``aggregate_offers`` (fakes, timeouts,
  dedup, unknown provider, a missing ``httpx``).
- The AbeBooks parser: the port builds its tree from the standard
  library's ``html.parser`` by bs4's rules (``pricing/providers/_html.py``),
  held to the JAX function, which runs BeautifulSoup, on the recorded page
  of ``tests/test_pricing.py`` and on seeded synthetic pages
  (``scripts/torch_port_reference.py::synthetic_abebooks_page``) that reach
  every selector and fallback of ``_parse_card``: the whole offer lists,
  the whole trees (every element, attribute and string with its kind) and
  every selector's matches.
- ``cli/pricing.py`` against ``bbocr_tpu/cli/pricing.py`` through the same
  canned HTTP clients, and the port's parser against the JAX outputs
  recorded in ``tests/data/pricing_jax.json`` (the card's check).
"""

import asyncio
import contextlib
import io
import json
import math
import os
import sys

import bs4
import httpx
import pytest
from bs4 import BeautifulSoup
from hypothesis import given, settings
from hypothesis import strategies as st

import bbocr_tpu.pricing.aggregator as jax_aggregator
import bbocr_tpu.pricing.providers.abebooks_html as jax_abe
import bbocr_tpu.pricing.providers.google_books as jax_gb
from bbocr_tpu.cli import pricing as jax_cli
from bbocr_tpu.pricing import parse as jax_parse
from bbocr_tpu.pricing import select as jax_select
from bbocr_tpu.pricing.providers import stubs as jax_stubs
from bbocr_tpu_torch.cli import pricing as port_cli
from bbocr_tpu_torch.pricing import aggregator as port_aggregator
from bbocr_tpu_torch.pricing import parse as port_parse
from bbocr_tpu_torch.pricing import select as port_select
from bbocr_tpu_torch.pricing.providers import _html
from bbocr_tpu_torch.pricing.providers import abebooks_html as port_abe
from bbocr_tpu_torch.pricing.providers import google_books as port_gb
from bbocr_tpu_torch.pricing.providers import stubs as port_stubs
from scripts.torch_port_reference import CannedHttp, pricing_queries, synthetic_abebooks_page
from tests.test_google_books import RECORDED
from tests.test_pricing import ABEBOOKS_HTML

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRICING_REFERENCE = os.path.join(ROOT, "tests", "data", "pricing_jax.json")
QUERY = dict(title=None, authors=[], isbn_13=None, isbn_10=None, publisher=None, publication_date=None)


# ---------------------------------------------------------------------------
# parse and select
# ---------------------------------------------------------------------------

_PRICE_WORDS = st.sampled_from(["USD", "usd", "GBP", "EUR", "CAD", "AUD", "US$", "C$", "CA$", "AU$", "$", "£", "€",
                                "Price:", "US DOLLARS", "", " ", "\t", "\n", "\xa0", "abc", "1987", "-"])
_NUMBERS = st.from_regex(r"[0-9][0-9.,]{0,9}", fullmatch=True)
_PRICE_TEXT = st.lists(st.one_of(_PRICE_WORDS, _NUMBERS), max_size=6).map(" ".join) | st.text(max_size=40)


def _same_amount(a, b) -> bool:
    """Equal, or NaN in both (``float`` reads 'NaN', and NaN equals nothing)."""
    return a == b or (isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b))


@settings(max_examples=300, deadline=None)
@given(text=_PRICE_TEXT)
def test_string_parsers_match_jax(text):
    assert port_parse.parse_price(text) == jax_parse.parse_price(text)
    assert _same_amount(port_parse.parse_amount(text), jax_parse.parse_amount(text))
    assert port_parse.extract_year(text) == jax_parse.extract_year(text)
    assert port_parse.norm_text(text) == jax_parse.norm_text(text)


@settings(max_examples=200, deadline=None)
@given(a=st.text(max_size=30) | st.sampled_from(["The Sea", "Sea, The (Paperback)", "the SEA", "Sea Vintage"]),
       b=st.text(max_size=30) | st.sampled_from(["The Sea", "The Sea (Vintage)", "Other Book", ""]))
def test_fuzzy_title_match_matches_jax(a, b):
    assert port_select.fuzzy_title_match(a, b) == jax_select.fuzzy_title_match(a, b)


_TITLES = st.sampled_from([None, "", "The Sea", "the sea", "The Sea (Vintage)", "Other Book", "Sea Vintage"])
_YEARS = st.sampled_from([None, "", "2005", "1999", "March 2005", "n.d."])
_ISBNS = st.sampled_from([None, "", "9780307263117", "978-0-307-26311-7", "0307263118"])
_AMOUNTS = st.sampled_from([None, 3.0, 8, 5.5, "12", 0.0])
_OFFERS = st.lists(st.builds(
    lambda provider, title, year, isbn_13, isbn_10, amount, authors: dict(
        port_parse.make_offer(provider, listing_id=f"{provider}-{title}-{amount}", title=title, publication_date=year,
                              isbn_13=isbn_13, isbn_10=isbn_10, amount=amount, currency="USD", authors=authors),
        publisher="P", subtitle=None, page_count=100),
    st.sampled_from(["a", "b", "c"]), _TITLES, _YEARS, _ISBNS, _ISBNS, _AMOUNTS,
    st.sampled_from([[], ["J. B."], ["X", "Y"]])), max_size=5)
_METADATA = st.builds(
    lambda title, year, isbn_13, isbn_10, authors, publisher: {
        "title": title, "year": year, "isbn_13": isbn_13, "isbn_10": isbn_10, "authors": authors,
        "publisher": publisher, "price": {"currency": None, "amount": None}},
    _TITLES, _YEARS, _ISBNS, _ISBNS, st.sampled_from([[], ["J. B."]]), st.sampled_from([None, "", "House"]))


@settings(max_examples=200, deadline=None)
@given(metadata=_METADATA, offers=_OFFERS)
def test_select_and_merge_match_jax(metadata, offers):
    got = port_select.select_best_offer(metadata, offers)
    assert got == jax_select.select_best_offer(metadata, offers)
    assert port_select.merge_offer_into_metadata(metadata, got[0]) == jax_select.merge_offer_into_metadata(
        metadata, got[0])


def test_make_offer_and_stubs_match_jax():
    kw = dict(listing_id="1", title="T", authors=["A"], amount=2.5, currency="GBP", url="u", source="scrape")
    assert port_parse.make_offer("x", **kw) == jax_parse.make_offer("x", **kw)
    assert port_parse.make_offer("x") == jax_parse.make_offer("x")
    for name in ("AmazonStubProvider", "BiblioStubProvider"):
        assert asyncio.run(getattr(port_stubs, name)().lookup(**QUERY)) == asyncio.run(
            getattr(jax_stubs, name)().lookup(**QUERY)) == []
    assert list(port_aggregator.DEFAULT_PROVIDERS) == list(jax_aggregator.DEFAULT_PROVIDERS)
    assert port_aggregator.DEFAULT_TIMEOUT_SECONDS == jax_aggregator.DEFAULT_TIMEOUT_SECONDS


# ---------------------------------------------------------------------------
# Google Books and the aggregator
# ---------------------------------------------------------------------------


@pytest.fixture
def canned(monkeypatch):
    """Both packages' HTTP clients replaced by canned ones: (port's, JAX's)."""
    pages = {"The Sea John Banville 2005": synthetic_abebooks_page(3)}
    ours, ref = CannedHttp(RECORDED, pages), CannedHttp(RECORDED, pages)
    monkeypatch.setattr(port_gb, "_async_client", ours)
    monkeypatch.setattr(port_abe, "_async_client", ours)
    monkeypatch.setattr(httpx, "AsyncClient", ref)
    monkeypatch.delenv("GOOGLE_BOOKS_API_KEY", raising=False)
    return ours, ref


@pytest.mark.parametrize("query", [
    dict(title="The Google Story", authors=["David Vise", "Mark Malseed"], isbn_13="9780553804577",
         isbn_10="055380457X", publisher="Random House"),
    dict(title="The Google Story"),
    dict(authors=["Only Author"]),
    dict(),
], ids=["all-terms", "title", "author", "empty"])
@pytest.mark.parametrize("api_key", [None, "sekrit"])
def test_google_books_matches_jax(canned, monkeypatch, query, api_key):
    if api_key:
        monkeypatch.setenv("GOOGLE_BOOKS_API_KEY", api_key)
    ours, ref = canned
    q = dict(QUERY, **query)
    got = asyncio.run(port_gb.GoogleBooksProvider().lookup(**q))
    assert got == asyncio.run(jax_gb.GoogleBooksProvider().lookup(**q))
    assert ours.requests == ref.requests
    assert len(got) == (0 if not query else 2)


def test_abebooks_lookup_matches_jax(canned):
    ours, ref = canned
    q = dict(QUERY, title="The Sea", authors=["John Banville"], publication_date="2005-01-01")
    got = asyncio.run(port_abe.AbeBooksHtmlProvider().lookup(**q))
    assert got and got == asyncio.run(jax_abe.AbeBooksHtmlProvider().lookup(**q))
    assert ours.requests == ref.requests
    assert ours.requests[0]["params"] == {"kn": "The Sea John Banville 2005", "sortby": "17"}


class _Fake:
    def __init__(self, offers=(), delay=0.0, error=None):
        self.offers, self.delay, self.error = list(offers), delay, error

    async def lookup(self, **query):
        if self.delay:
            await asyncio.sleep(self.delay)
        if self.error:
            raise self.error
        return [dict(o) for o in self.offers]


def _fakes(make_offer):
    same = make_offer("dup", listing_id="same", isbn_13="9780306406157")
    return {
        "fast": lambda: _Fake([make_offer("fast", listing_id="1", title="T")]),
        "boom": lambda: _Fake(error=RuntimeError("nope")),
        "slow": lambda: _Fake([make_offer("slow", listing_id="s")], delay=2.0),
        "dup": lambda: _Fake([same, same, make_offer("dup", listing_id="other")]),
    }


@pytest.mark.parametrize("providers,timeout", [
    (["fast", "boom"], 8.0), (["slow"], 0.05), (["dup"], 8.0), (["nope"], 8.0),
    (["fast", "dup", "nope", "boom", "slow"], 0.05), (None, 8.0),
], ids=["isolation", "timeout", "dedup", "unknown", "all", "defaults"])
def test_aggregate_offers_matches_jax(canned, monkeypatch, providers, timeout):
    for module, parse in ((port_aggregator, port_parse), (jax_aggregator, jax_parse)):
        for name, factory in _fakes(parse.make_offer).items():
            monkeypatch.setitem(module.DEFAULT_PROVIDERS, name, factory)
    if providers is None:  # the four default providers, through the canned clients
        for module in (port_aggregator, jax_aggregator):
            for name in ("fast", "boom", "slow", "dup"):
                monkeypatch.delitem(module.DEFAULT_PROVIDERS, name)
    q = dict(title="The Sea", authors=["John Banville"], publication_date="2005", providers=providers,
             timeout_seconds=timeout)
    got = asyncio.run(port_aggregator.aggregate_offers(**q))
    assert got == asyncio.run(jax_aggregator.aggregate_offers(**q))
    if providers is None:
        assert {o["provider"] for o in got[0]} == {"google_books", "abebooks"} and got[1] == {}


def test_a_missing_httpx_is_filed_as_the_providers_error(monkeypatch):
    """Without ``httpx`` the network providers raise ``ImportError`` naming
    it, which the aggregator files as their errors, as a network error."""
    monkeypatch.setitem(sys.modules, "httpx", None)
    with pytest.raises(ImportError, match="httpx"):
        asyncio.run(port_gb.GoogleBooksProvider().lookup(**dict(QUERY, title="T")))
    offers, errors = asyncio.run(port_aggregator.aggregate_offers(title="T", authors=["A"]))
    assert offers == []
    assert set(errors) == {"google_books", "abebooks"}
    assert all("httpx" in e for e in errors.values())


# ---------------------------------------------------------------------------
# The AbeBooks parser: the stdlib tree against BeautifulSoup
# ---------------------------------------------------------------------------

_KINDS = {bs4.element.NavigableString: "text", bs4.element.CData: "cdata", bs4.element.Comment: "comment",
          bs4.element.Doctype: "doctype", bs4.element.Declaration: "declaration",
          bs4.element.ProcessingInstruction: "pi", bs4.element.Script: "script", bs4.element.Stylesheet: "style",
          bs4.element.TemplateString: "template", bs4.element.RubyTextString: "rt",
          bs4.element.RubyParenthesisString: "rp"}


def _bs4_tree(node):
    if isinstance(node, bs4.element.NavigableString):
        return (_KINDS[type(node)], str(node))
    return (node.name, dict(node.attrs), [_bs4_tree(c) for c in node.contents])


def _port_tree(node):
    if isinstance(node, _html.Text):
        return (node.kind, node.value)
    return (node.name, {k: node.get(k) for k in node.attrs}, [_port_tree(c) for c in node.children])


def _path(el):
    """An element's position: the indices of it and its ancestors among their parents' elements."""
    out = []
    while el.parent is not None:
        kids = [c for c in (el.parent.contents if hasattr(el.parent, "contents") else el.parent.children)
                if not isinstance(c, (bs4.element.NavigableString, _html.Text))]
        out.append(next(i for i, c in enumerate(kids) if c is el))
        el = el.parent
    return out[::-1]


MARKUP = [
    "<ul><li>a<li>b</ul>c", "<p>x<p>y</div>z", "a<br>b</br>c", "a<br/>b</br>c",
    "<meta itemprop=price content='1,2'></meta>x", "<img src=a><img src=b></img></img>t", "<p/>t<br></p>",
    "<div class=' a  b\tc '>t &amp; &foo; &#65;&#x42;&#150;&#0; &nbsp;x &copy z</div>",
    "&#65a; &#x4g; &amp &ampx &#1234567; &#xD800; &#xFFFE; &#129; &#9;",
    "<!-- c --><!DOCTYPE html><![CDATA[x]]><?pi?><!ELEMENT x>",
    "<script>var a='<b>';</script><style>p{}</style><template><p>in</p></template><ruby>a<rt>b</rt><rp>(</rp></ruby>",
    "<pre>  \n </pre>  \n  <span> </span><textarea> </textarea>", "<a href=x href=y rel='nofollow  me' disabled>q</a>",
    "<li><li><li>", "</p>stray<b>bold</i>x</b>y", "<TD Class=X Headers='h1 h2'>a</td>", "<div><span>unclosed",
]


@pytest.mark.parametrize("markup", MARKUP, ids=range(len(MARKUP)))
def test_tree_matches_bs4_on_odd_markup(markup):
    assert _port_tree(_html.parse_html(markup)) == _bs4_tree(BeautifulSoup(markup, "html.parser"))


def test_numeric_references_match_bs4():
    deref = bs4.builder._htmlparser.BeautifulSoupHTMLParser._dereference_numeric_character_reference
    names = [str(n) for n in list(range(0, 0x300)) + [0xD7FF, 0xD800, 0xDFFF, 0xFDD0, 0xFFFE, 0x1FFFF, 0x10FFFF,
                                                      0x110000, 10 ** 9]]
    names += ["x41", "X41", "x0", "x9F", "xFFFF", "65a", "x4g", ""]
    for name in names:
        char, _, extra = deref(name)
        assert _html.numeric_reference(name) == (char, extra), name


PAGES = {"recorded": ABEBOOKS_HTML, **{f"synthetic_{s}": synthetic_abebooks_page(s) for s in range(40)}}
SELECTORS = list(jax_abe._CARD_SELECTORS) + list(jax_abe._PRICE_SELECTORS) + [
    "h2.srp-title", ".srp-title", "a.srp-item-detail-link", "a[href*='/bd']", "h2",
    ".author, .srp-author, .result-author, .text-muted", "meta[itemprop='priceCurrency']",
    "[itemprop='priceCurrency']", "a[id^='add-to-basket-link-']", "meta[itemprop='datePublished']",
    "[itemprop='datePublished']", "time[itemprop='datePublished']", "time", "ul li", "body .cf .result p",
    "[content]", "*", "div, li, span",
]


@pytest.mark.parametrize("name", list(PAGES))
def test_abebooks_parser_matches_bs4(name):
    """The whole offer lists for three queries, the whole tree, and each
    selector's matches, from the document and from every card."""
    page = PAGES[name]
    for q in pricing_queries("The Sea", "John Banville", "2005"):
        assert port_abe.parse_results_html(page, **q) == jax_abe.parse_results_html(page, **q)
    ours, ref = _html.parse_html(page), BeautifulSoup(page, "html.parser")
    assert _port_tree(ours) == _bs4_tree(ref)
    cards = next((c for c in (ref.select(s) for s in jax_abe._CARD_SELECTORS) if c), [])
    for sel in SELECTORS:
        assert [_path(e) for e in ours.select(sel)] == [_path(e) for e in ref.select(sel)], sel
        for card in cards:
            mine = ours
            for i in _path(card):
                mine = [c for c in mine.children if isinstance(c, _html.Element)][i]
            one = mine.select_one(sel)
            assert (None if one is None else _path(one)) == (lambda e: None if e is None else _path(e))(
                card.select_one(sel)), sel
            assert mine.get_text(" ", strip=True) == card.get_text(" ", strip=True)
            assert mine.get_text(strip=True) == card.get_text(strip=True)
            found = mine.find("h2")
            assert (None if found is None else _path(found)) == (
                None if card.find("h2") is None else _path(card.find("h2")))


@pytest.mark.parametrize("selector", ["a > b", "a + b", "a ~ b", ":not(a)", "a:first-child", "[a$='x']",
                                      "[a~='x']", "#id", "a,", ", a", "[a='x'", "a..b"])
def test_unsupported_selectors_raise(selector):
    with pytest.raises(ValueError):
        _html.parse_selector(selector)


def test_parser_matches_the_recorded_jax_outputs():
    """The card's check on the CPU: every recorded page and query of
    ``tests/data/pricing_jax.json`` parses to the JAX offers."""
    with open(PRICING_REFERENCE) as f:
        ref = json.load(f)
    assert len(ref["parses"]) >= 3 * len(ref["pages"])
    for case in ref["parses"]:
        assert port_abe.parse_results_html(ref["pages"][case["page"]], **case["query"]) == case["offers"], case


# ---------------------------------------------------------------------------
# cli/pricing.py
# ---------------------------------------------------------------------------


def _run_cli(main, argv, monkeypatch):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        if main is jax_cli.main:
            monkeypatch.setattr(sys, "argv", ["pricing", *argv])
            main()
        else:
            main(argv)
    return json.loads(printed.getvalue())


@pytest.mark.parametrize("argv", [
    ["--title", "The Sea", "--author", "John Banville", "--year", "2005", "--providers", "abebooks", "google_books"],
    ["--title", "The Sea", "--author", "John Banville", "--year", "2005", "--select"],
    ["--isbn-13", "9780553804577", "--providers", "google_books", "nope", "--select", "--timeout", "2"],
    ["--from-json", "{meta}", "--select"],
], ids=["providers", "select", "isbn", "from-json"])
def test_pricing_cli_matches_jax(canned, monkeypatch, tmp_path, argv):
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"title": "The Sea", "authors": ["John Banville"], "year": "2005"}))
    argv = [a.replace("{meta}", str(meta)) for a in argv]
    ours, ref = canned
    got = _run_cli(port_cli.main, argv, monkeypatch)
    assert got == _run_cli(jax_cli.main, argv, monkeypatch)
    assert sorted(map(json.dumps, ours.requests)) == sorted(map(json.dumps, ref.requests))


def test_pricing_cli_refuses_an_empty_query(monkeypatch, capsys):
    with pytest.raises(SystemExit) as ours:
        port_cli.main([])
    monkeypatch.setattr(sys, "argv", ["pricing"])
    with pytest.raises(SystemExit) as ref:
        jax_cli.main()
    assert ours.value.code == ref.value.code == 2
