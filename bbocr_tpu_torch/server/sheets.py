"""Google Sheets audit logging (the durable business-event log).

Same env/config surface and row formats as the reference
(``pipeline_demo/i2j_ui/app/google_sheets.py``): credentials from
GOOGLE_SHEETS_CREDENTIALS_JSON (path or inline JSON), spreadsheet id +
worksheet name env vars, lazy client/worksheet singletons, auto-created
worksheet seeded with the 16-column audit header, and a dual write format —
if the sheet's first row matches the 8-column inventory table header, write
that shape (Book Title / Author / Year / Publisher / Has ISBN / Link Found /
Accept/Reject / Comments); otherwise append the 16-column audit row.

Degrades to no-ops when gspread or config are absent.

Copied from ``bbocr_tpu/server/sheets.py``: ``gspread`` and ``google.oauth2``
are imported only inside ``_load_client``, when credentials are configured.
"""

from __future__ import annotations

import datetime
import json
import os
import re
import threading
from typing import Any, Dict, Optional

TABLE8_HEADER = [
    "Book Title", "Author", "Year", "Publisher",
    "Has ISBN", "Link Found", "Accept/Reject", "Comments",
]

AUDIT_HEADER = [
    "timestamp_iso", "stage", "action", "id", "source_path", "title",
    "authors_csv", "isbn_13", "isbn_10", "publisher", "publication_date",
    "pricing_provider", "price_amount", "price_currency", "comment", "error",
]

_lock = threading.Lock()
_client = None
_sheet = None
_last_error: Optional[str] = None


def _load_client():
    global _client, _last_error
    if _client is not None:
        return _client
    creds_env = os.environ.get("GOOGLE_SHEETS_CREDENTIALS_JSON")
    if not creds_env:
        _last_error = "missing GOOGLE_SHEETS_CREDENTIALS_JSON"
        return None
    try:
        import gspread
        from google.oauth2.service_account import Credentials
    except Exception as e:
        _last_error = f"deps_unavailable: {e}"
        return None
    try:
        scopes = [
            "https://www.googleapis.com/auth/spreadsheets",
            "https://www.googleapis.com/auth/drive.file",
            "https://www.googleapis.com/auth/drive",
        ]
        if creds_env.strip().startswith("{"):
            creds = Credentials.from_service_account_info(json.loads(creds_env), scopes=scopes)
        else:
            creds = Credentials.from_service_account_file(creds_env, scopes=scopes)
        _client = gspread.authorize(creds)
        return _client
    except Exception as e:
        _last_error = f"auth_error: {e}"
        return None


def _load_sheet():
    global _sheet, _last_error
    if _sheet is not None:
        return _sheet
    client = _load_client()
    if client is None:
        return None
    sheet_id = os.environ.get("GOOGLE_SHEETS_SPREADSHEET_ID")
    if not sheet_id:
        _last_error = "missing GOOGLE_SHEETS_SPREADSHEET_ID"
        return None
    try:
        book = client.open_by_key(sheet_id)
        name = os.environ.get("GOOGLE_SHEETS_WORKSHEET", "Sheet1")
        try:
            ws = book.worksheet(name)
        except Exception:
            ws = book.add_worksheet(title=name, rows="1000", cols="20")
            try:
                ws.append_row(AUDIT_HEADER)
            except Exception:
                pass
        _sheet = ws
        return _sheet
    except Exception as e:
        _last_error = f"sheet_open_failed: {e}"
        return None


def is_configured() -> bool:
    with _lock:
        return _load_sheet() is not None


def _year_of(value: Optional[str]) -> str:
    m = re.search(r"(18|19|20)\d{2}", str(value or ""))
    return m.group(0) if m else ""


def append_row(
    *,
    stage: str,
    action: str,
    id: Optional[str] = None,
    source_path: Optional[str] = None,
    comment: Optional[str] = None,
    metadata: Optional[Dict[str, Any]] = None,
    offer: Optional[Dict[str, Any]] = None,
    error: Optional[str] = None,
) -> Dict[str, Any]:
    with _lock:
        ws = _load_sheet()
        if ws is None:
            return {"ok": False, "error": "sheet_unavailable"}
        md = metadata if isinstance(metadata, dict) else {}
        authors = md.get("authors")
        if isinstance(authors, list):
            authors_csv = ", ".join(str(a) for a in authors if a is not None)
        else:
            authors_csv = authors if isinstance(authors, str) else ""
        offer = offer if isinstance(offer, dict) else {}

        try:
            header = ws.row_values(1)
        except Exception:
            header = []

        if header and header[: len(TABLE8_HEADER)] == TABLE8_HEADER:
            has_isbn = "yes" if (md.get("isbn_13") or md.get("isbn_10")) else "no"
            link_found = "yes" if (
                offer.get("url") or offer.get("info_url")
                or md.get("info_url") or md.get("source_url")
            ) else "no"
            decision = "accept" if str(action).lower().startswith("approv") else "reject"
            try:
                ws.append_row([
                    md.get("title") or "",
                    authors_csv or "",
                    _year_of(md.get("publication_date") or md.get("year")),
                    md.get("publisher") or "",
                    has_isbn,
                    link_found,
                    decision,
                    comment or "",
                ])
                return {"ok": True, "mode": "8col"}
            except Exception as e:
                return {"ok": False, "error": f"append_8col_failed: {e}"}

        ts = datetime.datetime.now(datetime.timezone.utc).isoformat()
        amount = offer.get("amount")
        try:
            ws.append_row([
                ts, stage, action, id or "", source_path or "",
                md.get("title") or "", authors_csv or "",
                md.get("isbn_13") or "", md.get("isbn_10") or "",
                md.get("publisher") or "",
                md.get("publication_date") or md.get("year") or "",
                offer.get("provider") or "",
                amount if isinstance(amount, (int, float)) else (amount or ""),
                offer.get("currency") or "",
                comment or "", error or "",
            ])
            return {"ok": True, "mode": "audit"}
        except Exception as e:
            return {"ok": False, "error": f"append_audit_failed: {e}"}


def connectivity() -> Dict[str, Any]:
    with _lock:
        if _load_client() is None:
            return {"ok": False, "error": "client_unavailable", "detail": _last_error}
        ws = _load_sheet()
        if ws is None:
            return {"ok": False, "error": "sheet_unavailable", "detail": _last_error}
        try:
            return {"ok": True, "worksheet": ws.title}
        except Exception as e:
            return {"ok": False, "error": str(e)}
