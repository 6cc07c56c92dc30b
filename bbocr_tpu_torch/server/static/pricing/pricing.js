/* Pricing SPA: provider fan-out, best-offer selection + merge, finalize.
 *
 * Role of the reference pricing frontend
 * (pipeline_demo/pricing_api/static/script.js), with one architectural
 * change: best-offer selection and merge run on the SERVER
 * (/api/pricing/select_best, bbocr_tpu.pricing.select) instead of in the
 * browser, so CLI/API/UI share one implementation. Receives scans via the
 * ?key= transfer fetch or the scannerAccepted postMessage.
 */

"use strict";

const $ = (id) => document.getElementById(id);
const PROVIDERS_DEFAULT_CHECKED = new Set(["abebooks"]);

const state = { query: null, offers: [], best: null, merged: null };

async function loadProviders() {
  const res = await fetch("/providers");
  const data = await res.json();
  const box = $("providers");
  box.innerHTML = "";
  for (const name of data.providers || []) {
    const label = document.createElement("label");
    const cb = document.createElement("input");
    cb.type = "checkbox";
    cb.value = name;
    cb.checked = PROVIDERS_DEFAULT_CHECKED.has(name);
    label.append(cb, " " + name);
    box.appendChild(label);
  }
}

async function loadProcessedList() {
  const res = await fetch("/processed/list");
  const data = await res.json();
  const sel = $("processed");
  for (const item of data.items || []) {
    const opt = document.createElement("option");
    opt.value = item.path;
    opt.textContent = item.label;
    sel.appendChild(opt);
  }
}

function setQuery(payload) {
  state.query = payload;
  const table = $("query-table");
  table.innerHTML = "";
  for (const key of ["title", "authors", "publisher", "publication_date", "isbn_13", "isbn_10"]) {
    const tr = document.createElement("tr");
    const k = document.createElement("td");
    k.textContent = key;
    const v = document.createElement("td");
    const value = payload ? payload[key] : null;
    v.textContent = value == null ? "" : (Array.isArray(value) ? value.join(", ") : String(value));
    tr.append(k, v);
    table.appendChild(tr);
  }
}

async function runLookup() {
  if (!state.query) { $("status").textContent = "no query loaded"; return; }
  const providers = [...$("providers").querySelectorAll("input:checked")].map((c) => c.value);
  $("status").textContent = "looking up…";
  const res = await fetch("/lookup", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ ...state.query, providers }),
  });
  const data = await res.json();
  state.offers = data.offers || [];
  $("status").textContent = `${state.offers.length} offers` +
    (Object.keys(data.errors || {}).length ? ` · errors: ${JSON.stringify(data.errors)}` : "");
  await selectBest();
}

async function selectBest() {
  const res = await fetch("/api/pricing/select_best", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ metadata: state.query || {}, offers: state.offers }),
  });
  const data = await res.json();
  state.best = data.best_offer;
  state.merged = data.merged;
  renderOffers(data.reason);
  renderMerged();
}

function renderOffers(reason) {
  const box = $("offers");
  box.innerHTML = "";
  for (const offer of state.offers) {
    const div = document.createElement("div");
    div.className = "offer" + (state.best && offer.listing_id === state.best.listing_id &&
      offer.provider === state.best.provider ? " best" : "");
    const price = offer.amount != null ? `${offer.currency || ""} ${offer.amount}` : "no price";
    div.innerHTML =
      `<span class="price">${price}</span> — ${offer.title || "(untitled)"}` +
      `<br><small>${offer.provider} · ${(offer.authors || []).join(", ")} · ` +
      `${offer.publication_date || "?"}${offer.url ? ` · <a href="${offer.url}" target="_blank">listing</a>` : ""}</small>`;
    box.appendChild(div);
  }
  if (state.best) {
    const note = document.createElement("div");
    note.innerHTML = `<small>best offer selected by: <b>${reason}</b></small>`;
    box.prepend(note);
  }
}

function renderMerged() {
  const table = $("merged-table");
  table.innerHTML = "";
  if (!state.merged) return;
  for (const [key, value] of Object.entries(state.merged)) {
    if (key.startsWith("_")) continue;
    const tr = document.createElement("tr");
    const k = document.createElement("td");
    k.textContent = key;
    const v = document.createElement("td");
    v.textContent = value == null ? "" : (typeof value === "object" ? JSON.stringify(value) : String(value));
    tr.append(k, v);
    table.appendChild(tr);
  }
  if (state.merged.price && state.merged.price.amount != null) {
    $("manual-price").value = state.merged.price.amount;
    $("manual-ccy").value = state.merged.price.currency || "USD";
  }
}

async function finalize(decision) {
  const merged = { ...(state.merged || state.query || {}) };
  const manual = parseFloat($("manual-price").value);
  if (Number.isFinite(manual)) {
    merged.price = { currency: $("manual-ccy").value || "USD", amount: manual };
  }
  const res = await fetch("/api/pricing/finalize", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({
      id: merged.title || null,
      decision,
      merged,
      best_offer: state.best,
      comment: $("comment").value,
    }),
  });
  const data = await res.json();
  $("final-status").textContent = `${data.status} → ${data.path || ""}`;
}

/* ------------------------- scan handoff ------------------------- */

async function loadTransfer() {
  const key = new URLSearchParams(location.search).get("key");
  if (!key) return;
  const res = await fetch(`/api/transfer_get?key=${key}`);
  if (!res.ok) return;
  const item = await res.json();
  setQuery(normalizeMeta(item.metadata || {}));
}

function normalizeMeta(md) {
  return {
    title: md.title ?? null,
    authors: Array.isArray(md.authors) ? md.authors : (md.authors ? [md.authors] : []),
    publisher: md.publisher ?? null,
    publication_date: md.publication_date ?? md.year ?? null,
    isbn_13: md.isbn_13 ?? null,
    isbn_10: md.isbn_10 ?? null,
  };
}

window.addEventListener("message", (ev) => {
  if (ev.data && ev.data.type === "scannerAccepted") {
    setQuery(normalizeMeta(ev.data.metadata || {}));
  }
});

$("btn-run").onclick = runLookup;
$("btn-approve").onclick = () => finalize("approved");
$("btn-reject").onclick = () => finalize("rejected");
$("processed").onchange = async (ev) => {
  if (!ev.target.value) return;
  const res = await fetch(`/processed/load?path=${encodeURIComponent(ev.target.value)}`);
  const data = await res.json();
  setQuery(normalizeMeta(data.payload || {}));
};

loadProviders();
loadProcessedList();
loadTransfer();
setQuery(null);
