/* BB-OCR TPU scanner SPA.
 *
 * Same responsibilities as the reference scanner frontend
 * (pipeline_demo/i2j_ui/static/script.js): webcam capture queue, multi
 * upload, SSE trace/log/job consumers with poll fallback, incremental trace
 * rendering with per-image previews, editable metadata review table that
 * round-trips types on Accept, accept -> pricing iframe handoff via the
 * transfer key + postMessage. Reimplemented, not ported.
 */

"use strict";

const $ = (id) => document.getElementById(id);

const state = {
  queue: [],            // File/Blob objects
  stream: null,         // MediaStream
  jobId: null,
  traceSeq: 0,
  logSeq: 0,
  sources: [],          // open EventSources
  pollTimers: [],
  metadata: null,
  heavy: {},            // imageIdx -> {field: dataUrl} cache (SSE sends once)
};

/* ------------------------------ health ------------------------------ */

async function refreshHealth() {
  const el = $("health");
  try {
    const res = await fetch("/api/health");
    const data = await res.json();
    el.textContent = data.pipeline_imported ? "pipeline ready" : "pipeline import failed";
    el.className = "pill " + (data.pipeline_imported ? "ok" : "err");
  } catch (e) {
    el.textContent = "server unreachable";
    el.className = "pill err";
  }
}

/* ----------------------------- capture ------------------------------ */

async function startCamera() {
  try {
    state.stream = await navigator.mediaDevices.getUserMedia({
      video: { facingMode: "environment", width: { ideal: 1920 } },
    });
    const video = $("video");
    video.srcObject = state.stream;
    $("video-wrap").hidden = false;
    $("btn-snap").disabled = false;
    video.addEventListener("loadedmetadata", updateCropOverlay);
    updateCropOverlay();
  } catch (e) {
    alert("Camera unavailable: " + e.message);
  }
}

/* Live edge-crop preview: a dashed box over the video showing the region
 * kept after central edge cropping (reference static/script.js:287-297). */
function updateCropOverlay() {
  const overlay = $("crop-overlay");
  const pct = Math.max(0, Math.min(45, Number($("edge-crop").value) || 0));
  if (!state.stream || pct <= 0) { overlay.hidden = true; return; }
  overlay.hidden = false;
  overlay.style.left = pct + "%";
  overlay.style.right = pct + "%";
  overlay.style.top = pct + "%";
  overlay.style.bottom = pct + "%";
}

function snapPage() {
  const video = $("video");
  const canvas = $("canvas");
  canvas.width = video.videoWidth;
  canvas.height = video.videoHeight;
  canvas.getContext("2d").drawImage(video, 0, 0);
  canvas.toBlob((blob) => {
    blob.name = `capture_${state.queue.length}.jpg`;
    addToQueue(blob);
  }, "image/jpeg", 0.92);
}

function addToQueue(fileOrBlob) {
  state.queue.push(fileOrBlob);
  const img = document.createElement("img");
  img.src = URL.createObjectURL(fileOrBlob);
  img.title = fileOrBlob.name || "page";
  $("queue").appendChild(img);
  $("btn-process").disabled = false;
}

function clearQueue() {
  state.queue = [];
  $("queue").innerHTML = "";
  $("btn-process").disabled = true;
}

/* ---------------------------- processing ---------------------------- */

async function processQueue() {
  if (!state.queue.length) return;
  closeStreams();
  $("trace").innerHTML = "";
  $("log").textContent = "";
  state.traceSeq = 0;
  state.logSeq = 0;
  state.heavy = {};
  setJobState("submitting", "busy");

  const fd = new FormData();
  for (const f of state.queue) fd.append("images", f, f.name || "page.jpg");
  fd.append("model", $("model").value);
  fd.append("llm_backend", $("backend").value);
  fd.append("ocr_engine", $("ocr-engine").value);
  fd.append("run_ocr", $("run-ocr").checked);
  fd.append("use_preprocessing", $("preproc").checked);
  fd.append("crop_ocr", $("crop-ocr").checked);
  fd.append("edge_crop", $("edge-crop").value || "0");

  const res = await fetch("/api/process_images", { method: "POST", body: fd });
  const data = await res.json();
  if (!res.ok) {
    setJobState(data.error || data.detail || "request failed", "err");
    return;
  }
  state.jobId = data.id;
  setJobState("queued", "busy");
  openStreams(data.id);
}

function setJobState(text, cls) {
  const el = $("job-state");
  el.textContent = text;
  el.className = "pill " + (cls || "");
}

/* ------------------------- SSE + poll fallback ----------------------- */

function openStreams(id) {
  sseWithFallback(`/api/trace_stream?id=${id}`, onTraceItem, () =>
    startPolling(`/api/trace_poll?id=${id}`, "traceSeq", onTraceItem));
  sseWithFallback(`/api/log_stream?id=${id}`, onLogItem, () =>
    startPolling(`/api/log_poll?id=${id}`, "logSeq", onLogItem));
  sseWithFallback(`/api/job_stream?id=${id}`, onStatusItem, () => pollJobStatus(id));
}

function sseWithFallback(url, onItem, fallback) {
  const src = new EventSource(url);
  let opened = false;
  src.onopen = () => { opened = true; };
  src.onmessage = (ev) => {
    try {
      const item = JSON.parse(ev.data);
      if (item.type === "ping" || item.type === "hello") return;
      if (item.type === "end") { src.close(); return; }
      onItem(item);
    } catch (e) { /* non-JSON frame */ }
  };
  src.onerror = () => {
    // fall back to polling after 2.2s if the stream never opened
    if (!opened) {
      setTimeout(() => { src.close(); fallback(); }, 2200);
    }
  };
  state.sources.push(src);
}

function startPolling(baseUrl, seqKey, onItem) {
  const timer = setInterval(async () => {
    try {
      const res = await fetch(`${baseUrl}&after=${state[seqKey]}`);
      const data = await res.json();
      for (const item of data.items || []) {
        state[seqKey] = item.seq;
        onItem(item);
      }
    } catch (e) { /* transient */ }
  }, 700);
  state.pollTimers.push(timer);
}

function pollJobStatus(id) {
  const timer = setInterval(async () => {
    const res = await fetch(`/api/job_status?id=${id}`);
    const job = await res.json();
    onStatusItem({ status: job.status, metadata: job.metadata, error: job.error });
    if (job.status === "done" || job.status === "error") clearInterval(timer);
  }, 900);
  state.pollTimers.push(timer);
}

function closeStreams() {
  for (const s of state.sources) s.close();
  for (const t of state.pollTimers) clearInterval(t);
  state.sources = [];
  state.pollTimers = [];
}

/* ------------------------------ trace ------------------------------- */

function onTraceItem(item) {
  state.traceSeq = item.seq || state.traceSeq;
  const trace = item.trace || {};
  renderTrace(trace);
}

function renderTrace(trace) {
  const panel = $("trace");
  panel.innerHTML = "";
  const imgs = document.createElement("div");
  imgs.className = "imgs";
  (trace.images || []).forEach((img, idx) => {
    const cache = state.heavy[idx] = state.heavy[idx] || {};
    for (const field of ["original_b64", "preprocessed_b64", "edge_cropped_b64", "auto_cropped_b64"]) {
      if (img[field]) cache[field] = img[field];   // heavy fields arrive once
      if (cache[field]) {
        const fig = document.createElement("figure");
        const el = document.createElement("img");
        el.src = cache[field];
        const cap = document.createElement("figcaption");
        cap.textContent = `#${idx} ${field.replace("_b64", "")}`;
        fig.append(el, cap);
        imgs.appendChild(fig);
      }
    }
    if (img.ocr_text) {
      const pre = document.createElement("pre");
      pre.textContent = `OCR #${idx}: ${img.ocr_text}`;
      imgs.appendChild(pre);
    }
  });
  panel.appendChild(imgs);
  for (const step of (trace.steps || []).slice(-12)) {
    const div = document.createElement("div");
    div.className = "step";
    div.textContent = step.step + (step.image_index != null ? ` (image ${step.image_index})` : "") +
      (step.info ? " " + JSON.stringify(step.info) : "");
    panel.appendChild(div);
  }
  if (trace.ollama_raw) {
    const pre = document.createElement("pre");
    pre.textContent = "VLM raw:\n" + trace.ollama_raw;
    panel.appendChild(pre);
  }
  panel.scrollTop = panel.scrollHeight;
}

function onLogItem(item) {
  state.logSeq = item.seq || state.logSeq;
  const log = $("log");
  log.textContent = (log.textContent + item.line + "\n").slice(-10000);
  log.scrollTop = log.scrollHeight;
}

function onStatusItem(item) {
  if (!item.status) return;
  if (item.status === "done") {
    setJobState("done", "ok");
    state.metadata = item.metadata || null;
    renderMetadata(state.metadata);
    closeStreams();
  } else if (item.status === "error") {
    setJobState("error: " + (item.error || ""), "err");
    closeStreams();
  } else {
    setJobState(item.status, "busy");
  }
}

/* --------------------------- metadata table -------------------------- */

function renderMetadata(meta) {
  const table = $("meta-table");
  table.innerHTML = "";
  if (!meta) return;
  for (const [key, value] of Object.entries(meta)) {
    if (key.startsWith("_")) continue;
    const tr = document.createElement("tr");
    const k = document.createElement("td");
    k.textContent = key;
    const v = document.createElement("td");
    v.contentEditable = "true";
    v.dataset.key = key;
    v.dataset.json = JSON.stringify(value);   // typed round-trip on Accept
    v.textContent = value === null ? "" : (typeof value === "object" ? JSON.stringify(value) : String(value));
    tr.append(k, v);
    table.appendChild(tr);
  }
  const usage = meta._processing_info && meta._processing_info.llm_usage;
  if (usage) {
    // per-request cloud cost (reference: gradio_GPT/app.py:139-143)
    const tr = document.createElement("tr");
    const k = document.createElement("td");
    k.textContent = "llm cost";
    k.style.opacity = "0.6";
    const v = document.createElement("td");
    v.style.opacity = "0.6";
    const dollars = usage.cost_usd != null ? ` · $${usage.cost_usd}` : "";
    v.textContent = `${usage.prompt_tokens ?? "?"} in / ${usage.completion_tokens ?? "?"} out tokens${dollars}`;
    tr.append(k, v);
    table.appendChild(tr);
  }
  $("btn-accept").disabled = false;
  $("btn-reject").disabled = false;
}

function readTable() {
  const out = {};
  for (const td of $("meta-table").querySelectorAll("td[data-key]")) {
    const key = td.dataset.key;
    const original = JSON.parse(td.dataset.json);
    const text = td.textContent.trim();
    if (text === "") { out[key] = Array.isArray(original) ? [] : null; continue; }
    if (original !== null && typeof original === "object") {
      try { out[key] = JSON.parse(text); } catch (e) { out[key] = original; }
    } else if (typeof original === "number") {
      const n = Number(text);
      out[key] = Number.isFinite(n) ? n : null;
    } else {
      out[key] = text;
    }
  }
  return out;
}

/* --------------------------- accept / reject -------------------------- */

async function accept() {
  const metadata = readTable();
  const res = await fetch("/api/accept", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ id: state.jobId || `item_${Date.now()}`, metadata }),
  });
  const data = await res.json();
  if (data.transfer_key) {
    const frame = $("pricing-frame");
    frame.src = `/pricing_embed?key=${data.transfer_key}`;
    frame.contentWindow?.postMessage({ type: "scannerAccepted", metadata }, "*");
    frame.scrollIntoView({ behavior: "smooth" });
  }
  setJobState("accepted", "ok");
}

async function reject() {
  await fetch("/api/reject", {
    method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify({ id: state.jobId || `item_${Date.now()}`, reason: $("reject-reason").value }),
  });
  setJobState("rejected", "");
}

/* ------------------------ per-backend model lists ---------------------- */

/* Reference static/script.js:225-263: each backend gets its own model
 * menu; ollama's is refreshed live from /api/models (tags proxy). */
const MODEL_LISTS = {
  ollama: ["gemma3:4b", "gemma3:12b", "llava:7b", "llava:13b", "moondream"],
  gemini: ["gemini-2.5-flash", "gemini-2.5-pro", "gemini-2.0-flash"],
  openai: ["gpt-4o-mini", "gpt-4o"],
  tpu: ["checkpoints/vlm.npz"],
  heuristic: [],
};

async function onBackendChange() {
  const backend = $("backend").value;
  const modelInput = $("model");
  let models = MODEL_LISTS[backend] || [];
  if (backend === "ollama") {
    try {
      const res = await fetch("/api/models");
      const data = await res.json();
      if (Array.isArray(data.models) && data.models.length) models = data.models;
    } catch (e) { /* fall back to the static list */ }
  }
  const list = $("model-list");
  list.innerHTML = "";
  for (const m of models) {
    const opt = document.createElement("option");
    opt.value = m;
    list.appendChild(opt);
  }
  modelInput.disabled = backend === "heuristic";
  if (backend === "heuristic") {
    modelInput.value = "";
  } else if (models.length && !models.includes(modelInput.value)) {
    modelInput.value = models[0];
  }
}

/* ------------------------------- wiring ------------------------------- */

$("backend").onchange = onBackendChange;
$("edge-crop").oninput = updateCropOverlay;
$("btn-cam").onclick = startCamera;
$("btn-snap").onclick = snapPage;
$("btn-process").onclick = processQueue;
$("btn-clear").onclick = clearQueue;
$("btn-accept").onclick = accept;
$("btn-reject").onclick = reject;
$("file-input").onchange = (ev) => {
  for (const f of ev.target.files) addToQueue(f);
  ev.target.value = "";
};

refreshHealth();
setInterval(refreshHealth, 30000);
onBackendChange();
