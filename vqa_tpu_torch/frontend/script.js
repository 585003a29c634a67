/* VQA frontend — speaks the same HTTP contract as the reference
 * (POST /predict multipart, GET /health). */

const API_BASE = window.location.pathname.startsWith("/app")
  ? window.location.origin
  : "http://localhost:8000";

const MAX_FILE_MB = 10;

const el = (id) => document.getElementById(id);
let currentFile = null;

// ---- health check: on load + periodic retry while offline ------------------
// (offline banner parity: reference frontend/script.js:353-368)
let healthTimer = null;
async function checkHealth() {
  const h = el("health");
  try {
    const r = await fetch(`${API_BASE}/health`);
    const j = await r.json();
    h.classList.remove("bad");
    h.classList.add(j.status === "healthy" ? "ok" : "bad");
    h.title = j.model_loaded
      ? "API healthy · trained model loaded"
      : "API healthy · random model (no checkpoint)";
    el("offline-banner").hidden = true;
    if (healthTimer) { clearInterval(healthTimer); healthTimer = null; }
  } catch {
    h.classList.remove("ok");
    h.classList.add("bad");
    h.title = "API unreachable";
    el("offline-banner").hidden = false;
    if (!healthTimer) healthTimer = setInterval(checkHealth, 10000);
  }
}
checkHealth();

// ---- image upload ----------------------------------------------------------
function setFile(file) {
  if (!file) return;
  if (!file.type.startsWith("image/")) {
    return setStatus("Please choose an image file.", true);
  }
  if (file.size > MAX_FILE_MB * 1024 * 1024) {
    return setStatus(`Image must be under ${MAX_FILE_MB} MB.`, true);
  }
  currentFile = file;
  const img = el("preview");
  img.src = URL.createObjectURL(file);
  img.hidden = false;
  el("dropzone").classList.add("has-image");
  el("clear-image").hidden = false;
  updateAskButton();
  setStatus("Image ready — ask away.");
}

el("clear-image").addEventListener("click", (e) => {
  e.stopPropagation();
  currentFile = null;
  el("preview").hidden = true;
  el("preview").src = "";
  el("clear-image").hidden = true;
  el("dropzone").classList.remove("has-image");
  el("file-input").value = "";
  updateAskButton();
  setStatus("Upload an image and ask a question.");
});

const dz = el("dropzone");
dz.addEventListener("dragover", (e) => { e.preventDefault(); dz.classList.add("drag"); });
dz.addEventListener("dragleave", () => dz.classList.remove("drag"));
dz.addEventListener("drop", (e) => {
  e.preventDefault();
  dz.classList.remove("drag");
  setFile(e.dataTransfer.files[0]);
});
el("file-input").addEventListener("change", (e) => setFile(e.target.files[0]));

// ---- question --------------------------------------------------------------
document.querySelectorAll(".example").forEach((b) =>
  b.addEventListener("click", () => {
    el("question").value = b.textContent;
    updateCharCount();
    updateAskButton();
  })
);
el("question").addEventListener("input", () => {
  updateCharCount();
  updateAskButton();
});
el("question").addEventListener("keydown", (e) => {
  if (e.key === "Enter" && !el("ask").disabled) submit();
});

function updateAskButton() {
  const q = el("question").value.trim();
  el("ask").disabled = !(currentFile && q.split(/\s+/).length >= 2);
}

// character counter (reference: frontend/script.js:30-40)
function updateCharCount() {
  const input = el("question");
  const max = input.maxLength > 0 ? input.maxLength : 200;
  const n = input.value.length;
  const c = el("char-count");
  c.textContent = `${n} / ${max}`;
  c.classList.toggle("near-limit", n >= max * 0.9);
}

// ---- predict ---------------------------------------------------------------
function setStatus(msg, isError = false, thinking = false) {
  const s = el("status");
  s.textContent = msg;
  s.classList.toggle("error", isError);
  s.classList.toggle("thinking", thinking);
  s.hidden = false;
}

async function submit() {
  const question = el("question").value.trim();
  const form = new FormData();
  form.append("image", currentFile);
  form.append("question", question);
  form.append("top_k", "5");

  // /attention = /predict + per-token cross-attention heatmaps
  const withAttention = el("show-attention").checked;
  const endpoint = withAttention ? "/attention" : "/predict";

  el("ask").disabled = true;
  el("result").hidden = true;
  setStatus("Thinking…", false, true);
  const t0 = performance.now();
  try {
    const r = await fetch(`${API_BASE}${endpoint}`, { method: "POST", body: form });
    const j = await r.json();
    if (!j.success) throw new Error(j.error || j.detail || "prediction failed");
    renderResult(j, performance.now() - t0);
    renderAttention(withAttention ? j.attention : null);
  } catch (err) {
    setStatus(`Error: ${err.message}`, true);
  } finally {
    el("ask").disabled = false;
  }
}
el("ask").addEventListener("click", submit);

function renderResult(j, ms) {
  el("status").hidden = true;
  el("result").hidden = false;
  el("top-answer").textContent = j.top_answer;
  const pct = Math.round(j.confidence * 100);
  el("confidence-fill").style.width = `${pct}%`;
  el("confidence-label").textContent = `${pct}% confident`;
  const ul = el("alternatives");
  ul.innerHTML = "";
  j.answers.slice(1).forEach((a) => {
    const li = document.createElement("li");
    li.style.setProperty("--p", (a.probability * 100).toFixed(1));
    li.innerHTML = `<span>${a.answer}</span><span>${(a.probability * 100).toFixed(1)}%</span>`;
    ul.appendChild(li);
  });
  el("timing").textContent = `answered in ${ms.toFixed(0)} ms`;
}

// ---- attention heatmaps ----------------------------------------------------
// Draws a token's [S,S] cross-attention map as a translucent overlay on the
// image; chips below switch between "all" (token average) and each token.
function renderAttention(att) {
  const box = el("attention-box");
  if (!att || !att.maps || !att.maps.length) {
    box.hidden = true;
    return;
  }
  box.hidden = false;
  el("attn-image").src = el("preview").src;

  // average over the REAL word tokens only — <START>/<END> carry diffuse
  // attention and are excluded from the chip list, so the default "all"
  // view must agree with the chips the user can select
  const special = new Set(["<START>", "<END>", "<PAD>"]);
  const wordMaps = att.maps.filter((_, i) => !special.has(att.tokens[i]));
  const maps = wordMaps.length ? wordMaps : att.maps;
  const avg = maps[0].map((row, y) =>
    row.map((_, x) =>
      maps.reduce((s, m) => s + m[y][x], 0) / maps.length
    )
  );

  const chips = el("attn-tokens");
  chips.innerHTML = "";
  const addChip = (label, map) => {
    const b = document.createElement("button");
    b.className = "attn-chip";
    b.textContent = label;
    b.addEventListener("click", () => {
      chips.querySelectorAll(".attn-chip").forEach((c) =>
        c.classList.remove("active"));
      b.classList.add("active");
      drawHeatmap(map, att.spatial_size);
    });
    chips.appendChild(b);
    return b;
  };
  const all = addChip("all", avg);
  att.tokens.forEach((t, i) => {
    if (t === "<START>" || t === "<END>" || t === "<PAD>") return;
    addChip(t, att.maps[i]);
  });
  all.classList.add("active");
  drawHeatmap(avg, att.spatial_size);
}

function drawHeatmap(map, size) {
  const canvas = el("attn-canvas");
  const img = el("attn-image");
  const paint = () => {
    canvas.width = img.clientWidth;
    canvas.height = img.clientHeight;
    const small = document.createElement("canvas");
    small.width = size;
    small.height = size;
    const sctx = small.getContext("2d");
    const data = sctx.createImageData(size, size);
    let max = 0;
    map.forEach((row) => row.forEach((v) => { if (v > max) max = v; }));
    for (let y = 0; y < size; y++) {
      for (let x = 0; x < size; x++) {
        const v = map[y][x] / (max || 1);
        const o = (y * size + x) * 4;
        data.data[o] = 255;            // warm overlay
        data.data[o + 1] = 80 * (1 - v);
        data.data[o + 2] = 40 * (1 - v);
        data.data[o + 3] = Math.round(185 * v); // alpha ∝ attention
      }
    }
    sctx.putImageData(data, 0, 0);
    const ctx = canvas.getContext("2d");
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    ctx.imageSmoothingEnabled = true;
    ctx.drawImage(small, 0, 0, canvas.width, canvas.height);
  };
  if (img.complete && img.clientWidth) paint();
  else img.onload = paint;
}
