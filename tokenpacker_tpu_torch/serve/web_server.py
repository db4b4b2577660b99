"""Web chat UI (counterpart of `tokenpacker_tpu/serve/web_server.py`; it
runs no model) — the reference's Gradio server role
(llava/serve/gradio_web_server.py) on stdlib HTTP (gradio is not in the
image). Serves a single-page chat app (image upload, temperature/top-p
controls, streaming), queries the controller for a worker per request,
auto-selects the conversation template from the model name
(gradio_web_server.py:167-193), and logs conversations/votes to dated JSON
with images saved by md5 (gradio_web_server.py:156-230) under LOGDIR.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tokenpacker_tpu_torch.constants import DEFAULT_IMAGE_TOKEN, LOGDIR
from tokenpacker_tpu_torch.data.conversation import SeparatorStyle, conv_templates
from tokenpacker_tpu_torch.serve.cli import pick_conv_mode
from tokenpacker_tpu_torch.utils.logging_utils import (
    MODERATION_MSG,
    build_logger,
    violates_moderation,
)

logger = build_logger("web_server", "web_server.log")

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>TokenPacker</title>
<style>
 body{font-family:system-ui;margin:2rem auto;max-width:760px}
 #log{border:1px solid #ccc;border-radius:8px;padding:1rem;min-height:320px;white-space:pre-wrap}
 .u{color:#036}.a{color:#063}
 textarea{width:100%;height:4rem}
 .row{display:flex;gap:.5rem;margin:.5rem 0}
</style></head><body>
<h2>TokenPacker chat</h2>
<div class="row">
 <select id="model"></select>
 <input type="file" id="img" accept="image/*">
 <select id="pmode" title="image preprocess mode">
  <option>Default</option><option>Crop</option><option>Resize</option><option>Pad</option>
 </select>
</div>
<div class="row">
 <label>T <input id="temp" type="number" step="0.1" min="0" max="1" value="0.2" style="width:4rem"></label>
 <label>top-p <input id="topp" type="number" step="0.1" min="0" max="1" value="0.7" style="width:4rem"></label>
 <label>max <input id="maxtok" type="number" min="1" max="1024" value="256" style="width:5rem"></label>
</div>
<div id="log"></div>
<div class="row"><textarea id="msg"></textarea><button id="send">Send</button></div>
<div class="row"><button data-v="upvote">&#128077;</button><button data-v="downvote">&#128078;</button>
<button data-v="flag">&#128681;</button>
<button id="regen">&#128260; Regenerate</button>
<button id="clear">Clear</button></div>
<script>
let history=[], imageB64=null;
fetch('/list_models').then(r=>r.json()).then(d=>{
  for(const m of d.models){const o=document.createElement('option');o.textContent=m;model.append(o)}});
img.onchange=()=>{const f=img.files[0];const r=new FileReader();
  r.onload=()=>{imageB64=r.result.split(',')[1]};r.readAsDataURL(f)};
async function run(){
  const resp=await fetch('/chat',{method:'POST',headers:{'Content-Type':'application/json'},
    body:JSON.stringify({model:model.value,history:history,image:imageB64,
      image_process_mode:pmode.value,temperature:parseFloat(temp.value),
      top_p:parseFloat(topp.value),max_new_tokens:parseInt(maxtok.value)})});
  const reader=resp.body.getReader();const dec=new TextDecoder();let buf='',out='';
  for(;;){const {done,value}=await reader.read();if(done)break;
    buf+=dec.decode(value,{stream:true});
    const parts=buf.split('\\0');buf=parts.pop();
    for(const p of parts){if(p){out=JSON.parse(p).text;render(out)}}}
  history.push(['assistant',out]);render('');
}
send.onclick=()=>{
  const text=msg.value.trim(); if(!text) return; msg.value='';
  history.push(['user',text]);render('');run();
};
regen.onclick=()=>{ // drop the last assistant turn and re-query (reference regenerate flow)
  if(!history.length) return;
  if(history[history.length-1][0]==='assistant') history.pop();
  if(!history.length) return;
  render('');run();
};
clear.onclick=()=>{history=[];imageB64=null;render('')};
document.querySelectorAll('[data-v]').forEach(b=>b.onclick=()=>
  fetch('/vote',{method:'POST',body:JSON.stringify({vote:b.dataset.v,history:history})}));
function render(partial){
  log.innerHTML=history.map(([r,t])=>`<div class="${r[0]}"><b>${r}:</b> ${t}</div>`).join('')
    +(partial?`<div class="a"><b>assistant:</b> ${partial}</div>`:'');
}
</script></body></html>"""


def _post_json(url, payload, timeout=10.0):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read() or b"{}")


def _apply_process_mode(conv, image_b64: str, mode: str) -> str:
    """Preprocess an uploaded base64 image through the conversation layer's
    Pad/Resize/Crop/Default semantics + size clamp (the reference does this
    in Conversation.get_images before the worker request —
    gradio_web_server.py:113-147, conversation.py process_image)."""
    import base64
    import io

    from PIL import Image as PILImage

    img = PILImage.open(io.BytesIO(base64.b64decode(image_b64))).convert("RGB")
    img = conv._resized_image(img, mode)
    out = io.BytesIO()
    img.save(out, format="PNG")
    return base64.b64encode(out.getvalue()).decode()


def _log_record(kind: str, payload: dict):
    os.makedirs(LOGDIR, exist_ok=True)
    name = datetime.datetime.now().strftime(f"%Y-%m-%d-{kind}.json")
    with open(os.path.join(LOGDIR, name), "a") as f:
        f.write(json.dumps({"tstamp": datetime.datetime.now().isoformat(), **payload}) + "\n")


def make_handler(controller_addr: str):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                data = PAGE.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif self.path == "/list_models":
                try:
                    models = _post_json(controller_addr + "/list_models", {})
                except Exception:
                    models = {"models": []}
                data = json.dumps(models).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.end_headers()
                self.wfile.write(data)
            else:
                self.send_response(404)
                self.end_headers()

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path == "/vote":
                _log_record("votes", body)
                self.send_response(200)
                self.end_headers()
                return
            if self.path != "/chat":
                self.send_response(404)
                self.end_headers()
                return

            # moderation hook (reference gradio_web_server.py:135): flag the
            # newest user turn before any worker dispatch
            last_user = next(
                (t for r, t in reversed(body.get("history", [])) if r == "user"), ""
            )
            if violates_moderation(last_user):
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.end_headers()
                self.wfile.write(
                    json.dumps({"text": MODERATION_MSG, "error_code": 3}).encode() + b"\0"
                )
                return

            model = body["model"]
            conv = conv_templates[pick_conv_mode(model)].copy()
            for i, (role, text) in enumerate(body.get("history", [])):
                tag = conv.roles[0] if role == "user" else conv.roles[1]
                if i == 0 and body.get("image") and DEFAULT_IMAGE_TOKEN not in text:
                    text = DEFAULT_IMAGE_TOKEN + "\n" + text
                conv.append_message(tag, text)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2

            image_b64 = body.get("image")
            if image_b64:
                md5 = hashlib.md5(image_b64.encode()).hexdigest()
                _log_record("images", {"md5": md5})

            try:
                addr = _post_json(controller_addr + "/get_worker_address", {"model": model})[
                    "address"
                ]
            except Exception:
                addr = ""
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.end_headers()
            if not addr:
                self.wfile.write(
                    json.dumps({"text": "No available worker", "error_code": 2}).encode() + b"\0"
                )
                return
            if image_b64:
                # the reference's gradio server preprocesses the upload
                # (Pad/Resize/Crop/Default + the 400/800px clamp) BEFORE the
                # worker sees it (Conversation.get_images,
                # gradio_web_server.py:113-147); same flow via the ported
                # Conversation._resized_image
                try:
                    image_b64 = _apply_process_mode(
                        conv, image_b64, body.get("image_process_mode", "Default")
                    )
                except Exception as e:  # bad upload/mode: surface, don't 500
                    self.wfile.write(
                        json.dumps({"text": f"image error: {e}", "error_code": 1}).encode()
                        + b"\0"
                    )
                    return
            payload = {
                "model": model,
                "prompt": prompt,
                "images": [image_b64] if image_b64 else None,
                "temperature": body.get("temperature", 0.2),
                "top_p": body.get("top_p", 0.7),
                "max_new_tokens": body.get("max_new_tokens", 256),
                "stop": stop,
            }
            req = urllib.request.Request(
                addr + "/worker_generate_stream",
                json.dumps(payload).encode(),
                {"Content-Type": "application/json"},
            )
            try:
                with urllib.request.urlopen(req, timeout=300) as resp:
                    buf = b""
                    while True:
                        data = resp.read(1)
                        if not data:
                            break
                        buf += data
                        if data == b"\0":
                            chunk = json.loads(buf[:-1])
                            text = chunk["text"]
                            # strip the echoed prompt for the UI
                            if text.startswith(prompt):
                                text = text[len(prompt) :]
                            self.wfile.write(
                                json.dumps({"text": text.strip()}).encode() + b"\0"
                            )
                            self.wfile.flush()
                            buf = b""
            except Exception as e:
                self.wfile.write(json.dumps({"text": f"error: {e}"}).encode() + b"\0")
            _log_record("conv", {"model": model, "history": body.get("history", [])})

    return Handler


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="localhost")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-address", default="http://localhost:21001")
    args = parser.parse_args(argv)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(args.controller_address))
    logger.info(f"web UI on http://{args.host}:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
