"""Interactive GILL chat demo on the port (counterpart of
demo/app_gradio.py; reference demo/app_gradio.py).

    python -m gill_tpu_torch.demo.app_gradio --model-dir checkpoints/gill_opt

Each user turn is wrapped as "Q: {text}\nA:" and the whole multimodal
conversation is the model's context; ret_scale_factor (default 1.3) and
temperature (> 0 switches top_p to 0.95) are exposed; dict outputs are
routed by the decision label and [IMG0..n) strings are stripped from the
shown text. With gradio installed the web demo launches (`build_blocks`
builds its Blocks, separate from `.launch()` so tests drive the
callbacks); without it a terminal REPL runs the same `ChatSession` (/img
PATH adds an image, /save exports, /quit). `export_conversation_html`
writes a self-contained HTML transcript, images inlined (the web UI's
"Export conversation" button, the REPL's /save). The model runs on the
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os

from PIL import Image

from gill_tpu_torch.utils.cli import add_device_arg, load_model, \
    resolve_device


class ChatSession:
    """Conversation state + one-turn inference (UI-agnostic core)."""

    def __init__(self, model, num_words=32, ret_scale_factor=1.3,
                 gen_scale_factor=1.0, temperature=0.0, max_num_imgs=1):
        self.model = model
        self.conversation = []  # interleaved [str | PIL.Image]
        self.num_words = num_words
        self.ret_scale_factor = ret_scale_factor
        self.gen_scale_factor = gen_scale_factor
        self.temperature = temperature
        self.max_num_imgs = max_num_imgs

    def add_image(self, img: Image.Image):
        img = img.resize((224, 224)).convert("RGB")
        self.conversation.append(img)

    def user_turn(self, text: str):
        self.conversation.append(f"Q: {text}\nA:")
        top_p = 0.95 if self.temperature > 0 else 1.0
        outs = self.model.generate_for_images_and_texts(
            self.conversation, num_words=self.num_words,
            ret_scale_factor=self.ret_scale_factor,
            gen_scale_factor=self.gen_scale_factor,
            temperature=self.temperature, top_p=top_p,
            max_num_rets=self.max_num_imgs)
        reply = []
        for out in outs:
            if isinstance(out, str):
                text_out = out
                for i in range(self.model.core.cfg.num_tokens):
                    text_out = text_out.replace(f"[IMG{i}]", "")
                text_out = text_out.strip()
                if text_out:
                    reply.append(text_out)
                self.conversation.append(out)
            elif isinstance(out, dict):
                decision = out["decision"][0] if out["decision"] else "gen"
                chosen = (out["ret"][0][0] if decision == "ret" and out["ret"]
                          else (out["gen"][0][0] if out["gen"] else None))
                if chosen is not None and isinstance(chosen, Image.Image):
                    reply.append(chosen)
                    self.conversation.append(chosen)
        return reply


def export_conversation_html(conversation, path: str) -> str:
    """Writes the interleaved conversation as one self-contained HTML file
    (images inlined as base64 data URIs) — the shareable-artifact
    counterpart of the reference's screenshot-and-upload share button."""
    import base64
    import html as html_mod
    import io

    parts = ["<!doctype html><meta charset='utf-8'>"
             "<title>GILL conversation</title>"
             "<body style='font-family:sans-serif;max-width:640px'>"
             "<h2>GILL conversation</h2>"]
    for item in conversation:
        if isinstance(item, Image.Image):
            buf = io.BytesIO()
            item.convert("RGB").save(buf, format="PNG")
            b64 = base64.b64encode(buf.getvalue()).decode("ascii")
            parts.append(f"<p><img src='data:image/png;base64,{b64}' "
                         f"style='max-width:256px'></p>")
        else:
            parts.append(f"<p>{html_mod.escape(str(item))}</p>")
    parts.append("</body>")
    with open(path, "w") as f:
        f.write("\n".join(parts))
    return path


def build_blocks(gr, model, args):
    """Constructs the gradio Blocks app (separated from .launch() so tests
    can drive the callbacks without a server)."""

    def respond(message, image, history, ret_scale, temperature, state):
        session = state or ChatSession(model)
        session.ret_scale_factor = ret_scale
        session.temperature = temperature
        if image is not None:
            session.add_image(Image.fromarray(image))
        reply = session.user_turn(message)
        shown = []
        for r in reply:
            shown.append(r if isinstance(r, str) else (r, "generated image"))
        history = (history or []) + [(message, shown)]
        return history, session

    def export(state):
        session = state
        if session is None or not session.conversation:
            return None
        n = len(os.listdir(args.save_dir))
        return export_conversation_html(
            session.conversation,
            os.path.join(args.save_dir, f"conversation_{n}.html"))

    with gr.Blocks() as demo:
        chat = gr.Chatbot()
        msg = gr.Textbox(label="Message")
        img = gr.Image(label="Upload image (optional)")
        ret_scale = gr.Slider(0.5, 3.0, value=1.3, label="ret_scale_factor")
        temp = gr.Slider(0.0, 1.0, value=0.0, label="temperature")
        state = gr.State(None)
        share_btn = gr.Button("Export conversation (shareable HTML)")
        share_file = gr.File(label="Exported conversation")
        msg.submit(respond, [msg, img, chat, ret_scale, temp, state],
                   [chat, state])
        share_btn.click(export, [state], [share_file])
    return demo


def launch_gradio(model, args):
    import gradio as gr

    demo = build_blocks(gr, model, args)
    demo.queue(max_size=1).launch(server_name=args.host, server_port=args.port)


def launch_repl(model, args):
    session = ChatSession(model)
    print("GILL chat. Commands: /img <path> to add an image, "
          "/save to export the conversation as HTML, /quit.")
    while True:
        try:
            line = input("you> ").strip()
        except EOFError:
            break
        if not line:
            continue
        if line == "/quit":
            break
        if line.startswith("/img "):
            session.add_image(Image.open(line[5:].strip()))
            print("(image added to context)")
            continue
        if line == "/save":
            n = len(os.listdir(args.save_dir))
            out = export_conversation_html(
                session.conversation,
                os.path.join(args.save_dir, f"conversation_{n}.html"))
            print(f"(conversation exported to {out})")
            continue
        for r in session.user_turn(line):
            if isinstance(r, str):
                print("gill>", r)
            else:
                n = len(os.listdir(args.save_dir))
                out = os.path.join(args.save_dir, f"gen_{n}.png")
                r.save(out)
                print(f"gill> [image saved to {out}]")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model-dir", default="checkpoints/gill_opt")
    p.add_argument("--weights-dir", default=None)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--save-dir", default="demo_outputs")
    add_device_arg(p)
    args = p.parse_args(argv)
    os.makedirs(args.save_dir, exist_ok=True)

    model = load_model(args.model_dir, resolve_device(args.device),
                       args.weights_dir)
    try:
        import gradio  # noqa: F401
    except ImportError:
        print("gradio not installed; starting terminal REPL instead.")
        launch_repl(model, args)
        return
    launch_gradio(model, args)


if __name__ == "__main__":
    main()
