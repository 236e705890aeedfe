"""Browser front end for the HTTP API: one HTML/JS page that the server
serves at GET / and that speaks the same JSON protocol as api/client.py
against the POST endpoints.

A copy of easyanimate_tpu/ui/web.py::INDEX_HTML (reference easyanimate/ui/
ui.py gradio layout, :680-1100); the port imports nothing of the JAX
package.
"""

INDEX_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>EasyAnimate-TPU</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { --bg:#101418; --panel:#1a2027; --edge:#2a333d; --fg:#e6ebf0;
          --dim:#93a1af; --accent:#4f8ef7; --ok:#3fb97f; --err:#e06c5e; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:14px/1.45 system-ui, sans-serif; }
  header { padding:14px 22px; border-bottom:1px solid var(--edge);
           display:flex; align-items:baseline; gap:12px; }
  header h1 { font-size:17px; margin:0; }
  header span { color:var(--dim); font-size:12px; }
  main { display:grid; grid-template-columns: 400px 1fr; gap:18px;
         padding:18px 22px; max-width:1250px; }
  .panel { background:var(--panel); border:1px solid var(--edge);
           border-radius:8px; padding:14px 16px; }
  .panel h2 { font-size:13px; text-transform:uppercase; letter-spacing:.06em;
              color:var(--dim); margin:0 0 10px; }
  label { display:block; margin:10px 0 4px; color:var(--dim); font-size:12px; }
  textarea, input[type=text], input[type=number], select {
    width:100%; background:var(--bg); color:var(--fg);
    border:1px solid var(--edge); border-radius:5px; padding:7px 9px;
    font:inherit; }
  textarea { resize:vertical; min-height:56px; }
  .row { display:flex; gap:10px; } .row > div { flex:1; }
  input[type=range] { width:100%; accent-color:var(--accent); }
  .val { float:right; color:var(--fg); }
  button { background:var(--accent); color:#fff; border:0; border-radius:6px;
           padding:10px 16px; font:inherit; font-weight:600; cursor:pointer;
           width:100%; margin-top:14px; }
  button.small { width:auto; padding:6px 12px; font-weight:400;
                 background:var(--edge); margin-top:8px; }
  button:disabled { opacity:.45; cursor:wait; }
  #status { margin-top:10px; font-size:12px; color:var(--dim);
            white-space:pre-wrap; }
  #status.ok { color:var(--ok); } #status.err { color:var(--err); }
  video, img.preview { width:100%; border-radius:6px; background:#000;
                       margin-top:8px; }
  details { margin-top:12px; border-top:1px solid var(--edge); padding-top:8px; }
  summary { cursor:pointer; color:var(--dim); font-size:12px;
            text-transform:uppercase; letter-spacing:.06em; }
  .imgslot { border:1px dashed var(--edge); border-radius:6px; padding:8px;
             margin-top:6px; text-align:center; color:var(--dim);
             font-size:12px; }
  .imgslot img { max-width:100%; max-height:110px; display:block;
                 margin:6px auto 0; border-radius:4px; }
  a.clear { color:var(--err); font-size:11px; cursor:pointer; }
</style>
</head>
<body>
<header><h1>EasyAnimate&#8209;TPU</h1>
<span>text / image / video &rarr; video &middot; v5e serving</span></header>
<main>
  <section class="panel">
    <h2>Generate</h2>
    <label>Prompt</label>
    <textarea id="prompt">A young bear is playing a guitar by the campfire, realistic, 4k.</textarea>
    <label>Negative prompt</label>
    <textarea id="negative">Blurring, mutation, deformation, distortion, dark and solid, comics.</textarea>
    <div class="row">
      <div><label>Method</label>
        <select id="method">
          <option>Video Generation</option>
          <option>Image Generation</option>
          <option>Long Video Generation</option>
        </select></div>
      <div><label>Window (long video)</label>
        <input type="number" id="partial" value="49" step="4"></div>
      <div><label>Overlap</label>
        <input type="number" id="overlap" value="4" step="1"></div>
      <div><label>Sampler</label>
        <select id="sampler">
          <option value="">(model default)</option>
          <option>Flow</option>
          <option>Euler</option>
          <option>Euler A</option>
          <option>DPM++</option>
          <option>PNDM</option>
          <option>DDIM</option>
        </select></div>
      <div><label>Seed</label><input type="number" id="seed" value="43"></div>
    </div>
    <div class="row">
      <div><label>Width</label><input type="number" id="width" value="672" step="16"></div>
      <div><label>Height</label><input type="number" id="height" value="384" step="16"></div>
    </div>
    <label>Frames (4k+1) <span class="val" id="lengthv">49</span></label>
    <input type="range" id="length" min="1" max="121" step="4" value="49"
           oninput="lengthv.textContent=this.value">
    <label>Steps <span class="val" id="stepsv">25</span></label>
    <input type="range" id="steps" min="1" max="100" value="25"
           oninput="stepsv.textContent=this.value">
    <label>CFG scale <span class="val" id="cfgv">6.0</span></label>
    <input type="range" id="cfg" min="1" max="20" step="0.5" value="6"
           oninput="cfgv.textContent=(+this.value).toFixed(1)">
    <label>CFG skip (tail ratio, 0 = off) <span class="val"
           id="cfgskipv">0.00</span></label>
    <input type="range" id="cfgskip" min="0" max="1" step="0.05" value="0"
           oninput="cfgskipv.textContent=(+this.value).toFixed(2)">
    <details>
      <summary>Image to video</summary>
      <div class="imgslot" id="startslot">start image — click to choose
        <input type="file" id="startfile" accept="image/*" hidden></div>
      <div class="imgslot" id="endslot">end image (optional) — click to choose
        <input type="file" id="endfile" accept="image/*" hidden></div>
    </details>
    <details>
      <summary>Model management</summary>
      <label>Edition</label>
      <select id="edition">
        <option value="v5.1" selected>EasyAnimateV5.1</option>
        <option value="v5">EasyAnimateV5</option>
        <option value="v4">EasyAnimateV4</option>
        <option value="v3">EasyAnimateV3</option>
      </select>
      <button class="small" onclick="updateEdition()">Switch edition</button>
      <label>Transformer checkpoint path</label>
      <input type="text" id="ckpt" placeholder="/path/EasyAnimateV5.1-12b-zh">
      <button class="small" onclick="updateModel()">Load checkpoint</button>
      <label>LoRA path &middot; scale</label>
      <div class="row">
        <div style="flex:3"><input type="text" id="lora" placeholder="none"></div>
        <div><input type="number" id="lorascale" value="0.55" step="0.05"></div>
      </div>
      <button class="small" onclick="updateLora()">Apply LoRA</button>
    </details>
    <button id="go" onclick="generate()">Generate</button>
    <div id="status">ready</div>
  </section>
  <section class="panel">
    <h2>Result</h2>
    <video id="out" controls loop hidden></video>
    <img id="outimg" class="preview" hidden>
  </section>
</main>
<script>
const $ = id => document.getElementById(id);
const images = { start: null, end: null };
for (const k of ["start", "end"]) {
  $(k + "slot").onclick = () => $(k + "file").click();
  $(k + "file").onchange = e => {
    const f = e.target.files[0];
    if (!f) return;
    const rd = new FileReader();
    rd.onload = () => {
      images[k] = rd.result.split(",")[1];  // strip data: prefix
      const slot = $(k + "slot");
      slot.querySelectorAll("img,a").forEach(n => n.remove());
      const im = new Image(); im.src = rd.result; slot.appendChild(im);
      const a = document.createElement("a");
      a.className = "clear"; a.textContent = "clear";
      a.onclick = ev => { ev.stopPropagation(); images[k] = null;
                          im.remove(); a.remove(); };
      slot.appendChild(a);
    };
    rd.readAsDataURL(f);
  };
}
function setStatus(msg, cls) {
  const s = $("status"); s.textContent = msg; s.className = cls || "";
}
async function post(path, payload) {
  const r = await fetch(path, { method: "POST",
    headers: { "Content-Type": "application/json" },
    body: JSON.stringify(payload) });
  const body = await r.json();
  if (!r.ok || body.message !== "Success")
    throw new Error(body.message || ("HTTP " + r.status));
  return body;
}
async function generate() {
  const t0 = Date.now();
  $("go").disabled = true;
  setStatus("generating\\u2026 (first request compiles; may take minutes)");
  const payload = {
    prompt_textbox: $("prompt").value,
    negative_prompt_textbox: $("negative").value,
    generation_method: $("method").value,
    width_slider: +$("width").value, height_slider: +$("height").value,
    length_slider: +$("length").value, sample_step_slider: +$("steps").value,
    cfg_scale_slider: +$("cfg").value, seed_textbox: +$("seed").value,
  };
  if ($("sampler").value) payload.sampler_dropdown = $("sampler").value;
  if ($("method").value === "Long Video Generation") {
    payload.partial_video_length = +$("partial").value;
    payload.overlap_video_length = +$("overlap").value;
  }
  if (+$("cfgskip").value > 0) payload.cfg_skip_ratio = +$("cfgskip").value;
  if (images.start) payload.start_image = images.start;
  if (images.end) payload.end_image = images.end;
  try {
    const body = await post("/easyanimate/infer_forward", payload);
    const v = $("out");
    v.src = "data:video/mp4;base64," + body.base64_encoding;
    v.hidden = false; $("outimg").hidden = true; v.play();
    setStatus("done in " + ((Date.now() - t0) / 1000).toFixed(1) + " s", "ok");
  } catch (e) { setStatus(String(e), "err"); }
  $("go").disabled = false;
}
async function updateModel() {
  setStatus("loading checkpoint\\u2026");
  try {
    await post("/easyanimate/update_diffusion_transformer",
               { diffusion_transformer_path: $("ckpt").value });
    setStatus("checkpoint loaded", "ok");
  } catch (e) { setStatus(String(e), "err"); }
}
async function updateEdition() {
  try {
    await post("/easyanimate/update_edition", { edition: $("edition").value });
    setStatus("edition switched to " + $("edition").value, "ok");
  } catch (e) { setStatus(String(e), "err"); }
}
async function updateLora() {
  try {
    await post("/easyanimate/update_lora",
               { lora_model_path: $("lora").value || null,
                 lora_alpha_slider: +$("lorascale").value });
    setStatus("LoRA applied", "ok");
  } catch (e) { setStatus(String(e), "err"); }
}
</script>
</body>
</html>
"""
