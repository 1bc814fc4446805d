"""Interactive demo with the port: a Gradio UI with two tabs (style-prompt
and reference-wav conditioning) when ``gradio`` is installed, otherwise a
command-line fallback that reads the content and the condition from
standard input and writes ``demo_out.wav``.

Counterpart of ``app.py``; its defaults are ``conf/demo.yaml``'s, so it
builds the demo model (legacy relative positions, as the published demo
checkpoint was trained)::

    python3 -m promptttspp_tpu_torch.app path.root=<repo> \\
        model_ckpt=<model.ckpt> vocoder_ckpt=<vocoder.ckpt> \\
        [mel_stats_file=<stats.yaml>] [+prewarm=true] \\
        [+prewarm_grid=speculative|full] [+prewarm_max_phones=208] \\
        [+speculative=true] [device=cpu]

It runs on ``cuda``; ``device=cpu`` runs it on the CPU. G2P is
``g2p_en`` when installed; otherwise the content is a space-separated ARPA
phoneme string.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Sequence

import numpy as np

from promptttspp_tpu_torch.bin import conf
from promptttspp_tpu_torch.bin.synthesize import (
    build_synthesizer as build_cli_synthesizer, read_wav)
from promptttspp_tpu_torch.infer import write_wav
from promptttspp_tpu_torch.text import eng

PUNCT_TO_SIL = {",", ".", "!", "?", ";"}


def content_to_sequence(content: str):
    """Text -> phoneme ids through ``g2p_en`` (punctuation -> sil, symbols
    outside the table dropped); without ``g2p_en``, a space-separated ARPA
    phoneme string -> ids."""
    try:
        from g2p_en import G2p
    except ImportError:
        tokens = content.split()
        if all(eng.is_symbol(t) for t in tokens):
            return eng.text_to_sequence(content)
        raise SystemExit(
            "g2p_en is not installed; provide the content as a "
            "space-separated ARPA phoneme string instead")
    phones = G2p()(content)
    phones = ["sil" if p in PUNCT_TO_SIL else p for p in phones]
    phones = [p for p in phones if eng.is_symbol(p)]
    return eng.text_to_sequence(" ".join(phones))


def load_wav_24k(path) -> np.ndarray:
    """A wav file -> mono float32 at 24 kHz."""
    sr, wav = read_wav(path)
    if wav.ndim > 1:
        wav = wav.mean(axis=-1)
    if sr != 24000:
        from scipy.signal import resample_poly

        wav = resample_poly(wav, 24000, sr).astype(np.float32)
    return wav


def build_synthesizer(cfg: Dict):
    """The CLI's synthesizer with the demo's ``mel_stats_file``; with
    ``prewarm``, ``Synthesizer.prewarm`` over ``prewarm_grid`` (default
    "speculative" for a speculative synthesizer, else "full") up to
    ``prewarm_max_phones`` at the deployment's ``use_max`` and
    ``noise_scale``, before the first request."""
    synth = build_cli_synthesizer(cfg, mel_stats_file=cfg["mel_stats_file"])
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    if cfg.get("prewarm"):
        if synth.vocoder_mode != "batched":
            log("prewarm: skipped, the grid covers vocoder_mode=batched "
                f"only, not {synth.vocoder_mode}")
        else:
            synth.prewarm(
                grid=cfg.get("prewarm_grid",
                             "speculative" if synth.speculative else "full"),
                max_phones=int(cfg.get("prewarm_max_phones", 208)),
                use_max=cfg.get("use_max", True),
                noise_scale=cfg.get("noise_scale", 0.5), log=log)
    return synth


def main(argv: Optional[Sequence[str]] = None):
    cfg = conf.compose("demo", sys.argv[1:] if argv is None else argv)
    conf.enter_run_dir(cfg)
    synth = build_synthesizer(cfg)
    kw = dict(use_max=cfg.get("use_max", True),
              noise_scale=cfg.get("noise_scale", 0.5))

    def synthesize(content, style_prompt=None, reference_wav_path=None):
        seq = content_to_sequence(content)
        if style_prompt is not None:
            wavs, _ = synth.synthesize([seq], prompts=[style_prompt],
                                       return_mels=False, **kw)
        else:
            wavs, _ = synth.synthesize(
                [seq], reference_wavs=[load_wav_24k(reference_wav_path)],
                return_mels=False, **kw)
        return 24000, (np.clip(wavs[0], -1, 1) * 32767).astype(np.int16)

    try:
        import gradio as gr
    except ImportError:
        gr = None
    if gr is None:
        print("gradio not installed: CLI mode")
        content = input("content (text or ARPA phonemes): ")
        cond = input("style prompt (or @/path/to/reference.wav): ")
        if cond.startswith("@"):
            sr, wav = synthesize(content, reference_wav_path=cond[1:])
        else:
            sr, wav = synthesize(content, style_prompt=cond)
        write_wav("demo_out.wav", wav.astype(np.float32) / 32767.0, sr)
        print("wrote demo_out.wav")
        return
    with gr.Blocks() as demo:
        gr.Markdown("# PromptTTS++ (PyTorch/CUDA)")
        content = gr.Textbox(label="Content prompt")
        with gr.Tabs():
            with gr.TabItem("Style prompt"):
                style = gr.Textbox(
                    label="Style prompt",
                    value="A man speaks with a low voice slowly.")
                btn1 = gr.Button("Synthesize")
                audio1 = gr.Audio(label="Output wav", elem_id="prompt")
            with gr.TabItem("Reference wav"):
                ref_wav = gr.Audio(type="filepath", label="Reference wav",
                                   elem_id="ref")
                btn2 = gr.Button("Synthesize")
                audio2 = gr.Audio(label="Output wav", elem_id="ref")
        btn1.click(lambda c, s: synthesize(c, style_prompt=s),
                   [content, style], audio1)
        btn2.click(lambda c, p: synthesize(c, reference_wav_path=p),
                   [content, ref_wav], audio2)
    demo.launch(server_name=cfg.get("host", "0.0.0.0"),
                server_port=cfg.get("port", 7860))


if __name__ == "__main__":
    main()
