"""Batched serving: prefill, then greedy or temperature decode over a KV
cache (a ring under a sliding window) or a recurrent state; an
encoder-decoder (whisper) takes frames, encodes them once in prefill and
attends to that output in every decode step; a vision-language model
(internvl2) takes patches, projected in front of the prompt in prefill.

    python -m repro_torch.launch.serve [--arch smollm-135m|mamba2-130m|...]
        [--batch 8] [--prompt-len 32] [--max-new 32] [--full-size]
        [--n-layers L] [--device cpu]

Runs on ``cuda`` unless ``--device`` says otherwise.  The model is cut to
``reduced()`` size, as the JAX CLI cuts it, unless ``--full-size``, and to
``--n-layers`` layers where that is given; its weights are drawn from seed
0 and it decodes greedily.  An encoder-decoder's frames (batch,
n_frames, d_model) and a vision-language model's patches (batch,
n_patches, vit_dim) are drawn at scale 0.02 from a numpy generator of seed
0.  The KV cache holds the prompt, the patches in front of it and the
decoded tokens, with 8 positions to spare.  Prints one JSON line: the
timings, tokens/s and peak device memory, and the first two sequences.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.steps import _prefill_capacity, make_decode_step
from repro_torch.models import model as model_mod


class Engine:
    """Minimal batched inference engine around prefill / decode_step.
    ``window`` (else the config's ``attn_window``) slides the attention
    window; its KV caches are then rings of min(capacity, window).  A
    request whose positions (the patches in front of the prompt
    included) outgrow the KV cache is refused (the reference drops the
    writes past its end: ROADMAP queue 3 item 28), and so is one that
    outgrows a learned ``pos_embed`` table (the reference would reuse the
    table's last row: ROADMAP queue 3 item 26)."""

    def __init__(self, cfg, params, *, window: Optional[int] = None,
                 capacity: int = 512, cache_dtype=torch.bfloat16):
        self.cfg, self.params = cfg, params
        self.window, self.capacity = window, capacity
        self.cache_dtype = cache_dtype
        self._decode = make_decode_step(cfg, window=window)
        self.timing = {}

    @torch.no_grad()
    def generate(self, tokens, *, max_new: int = 32, frames=None,
                 patches=None, temperature: float = 0.0, seed: int = 0,
                 return_logits: bool = False):
        """tokens (B, S) -> (B, max_new) int32 numpy: greedy when
        ``temperature`` is 0, else sampled with a generator seeded by
        ``seed``.  ``frames`` (B, T, D): an encoder-decoder's input,
        encoded once in prefill; every decode step recomputes its cross
        attention's k and v from that output, as the reference does.
        ``patches`` (B, P, vit_dim): a vision-language model's input,
        projected in front of the prompt, which is then P + S positions
        long.  With
        ``return_logits`` also the (B, max_new, V) f32 logits each token was
        picked from.  ``self.timing`` holds the
        prefill's and the decode steps' seconds, each ended by a device
        synchronisation."""
        dev = self.params["embed"].device
        tok = torch.as_tensor(np.asarray(tokens), dtype=torch.int64,
                              device=dev)
        B, S = tok.shape
        if patches is not None:
            S += np.asarray(patches).shape[1]
        # the KV cache holds what the request writes, or under a window a
        # ring that is at least as long as the window (shorter, it would
        # overwrite positions still inside the window)
        win = self.window if self.window is not None else self.cfg.attn_window
        if "attn" in self.cfg.layer_pattern and S + max_new - 1 > \
                self.capacity and not (win and self.capacity >= win):
            raise ValueError(f"prompt {S} + {max_new - 1} decoded tokens "
                             f"exceed the KV cache's {self.capacity}"
                             + (f", a ring shorter than the window {win}"
                                if win else ""))
        if "pos_embed" in self.params and S + max_new - 1 > \
                self.params["pos_embed"].shape[0]:
            raise ValueError(f"prompt {S} + {max_new - 1} decoded tokens "
                             f"outgrow the pos_embed table's "
                             f"{self.params['pos_embed'].shape[0]} positions")
        batch = {"tokens": tok}
        if frames is not None:
            batch["frames"] = torch.as_tensor(np.asarray(frames),
                                              device=dev)
        if patches is not None:
            batch["patches"] = torch.as_tensor(np.asarray(patches),
                                               device=dev)
        gen = (torch.Generator(device=dev).manual_seed(seed)
               if temperature > 0.0 else None)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: 0)
        sync()
        t0 = time.perf_counter()
        logits, caches, enc_out = model_mod.prefill(
            self.params, self.cfg, batch, capacity=self.capacity,
            window=self.window, cache_dtype=self.cache_dtype)
        seen = [logits[:, -1]]
        outs = [self._pick(logits[:, -1], temperature, gen)]
        sync()
        t1 = time.perf_counter()
        for _ in range(max_new - 1):
            logits, caches = self._decode(self.params, caches, outs[-1],
                                          enc_out)
            seen.append(logits[:, -1])
            outs.append(self._pick(logits[:, -1], temperature, gen))
        sync()
        self.timing = {"prefill_s": t1 - t0,
                       "decode_s": time.perf_counter() - t1,
                       "decode_steps": max_new - 1}
        out = torch.cat(outs, dim=1).to(torch.int32).cpu().numpy()
        if return_logits:
            return out, torch.stack(seen, 1).to(torch.float32).cpu().numpy()
        return out

    @staticmethod
    def _pick(logits, temperature, gen):
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)


def build(arch: str, *, full_size: bool = False,
          n_layers: Optional[int] = None, device=None) -> tuple:
    """``arch``'s config (``reduced()`` unless ``full_size``; ``n_layers``,
    if given, cuts its depth) and its weights drawn from seed 0, on
    ``device``."""
    from repro_torch.configs import get_arch
    from repro_torch.tree import tree_map

    cfg = get_arch(arch)
    if not full_size:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = cfg.replace(n_layers=n_layers)
    # drawn on the CPU, so a seed gives the same weights on every device
    params = tree_map(lambda t: t.to(resolve_device(device)),
                      model_mod.init_params(cfg,
                                            torch.Generator().manual_seed(0)))
    return cfg, params


def serve(arch: str = "smollm-135m", batch: int = 8, prompt_len: int = 32,
          max_new: int = 32, *, full_size: bool = False,
          n_layers: Optional[int] = None, device=None) -> dict:
    """The CLI's run: a model from ``build``, ``batch`` synthetic prompts
    (and an encoder-decoder's frames or a vision-language model's
    patches), one greedy ``generate``.  Returns the tokens, the timings
    and, on a card, its peak memory."""
    from repro_torch.data import synthetic

    dev = resolve_device(device)
    cfg, params = build(arch, full_size=full_size, n_layers=n_layers,
                        device=dev)
    prompts = synthetic.lm_stream(cfg.vocab_size, batch, prompt_len, seed=0)
    eng = Engine(cfg, params, window=cfg.attn_window,
                 capacity=_prefill_capacity(cfg, {"tokens": prompts})
                 + max_new + 8)
    frames = patches = None
    if cfg.encoder is not None:
        frames = 0.02 * np.random.default_rng(0).standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    if cfg.vision is not None:
        patches = 0.02 * np.random.default_rng(0).standard_normal(
            (batch, cfg.vision.n_patches, cfg.vision.vit_dim),
            dtype=np.float32)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tokens = eng.generate(prompts, max_new=max_new, frames=frames,
                          patches=patches)
    t = eng.timing
    out = {"arch": arch, "full_size": full_size, "n_layers": cfg.n_layers,
           "device": str(dev),
           "batch": batch, "prompt_len": prompt_len, "max_new": max_new,
           "prefill_ms": t["prefill_s"] * 1e3,
           "decode_ms_per_token": (t["decode_s"] * 1e3
                                   / max(t["decode_steps"], 1)),
           "tokens_per_s": batch * max_new / (t["prefill_s"]
                                              + t["decode_s"]),
           "tokens": tokens, "engine": eng, "prompts": prompts,
           "frames": frames, "patches": patches}
    if dev.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--full-size", action="store_true",
                    help="the published configuration, not reduced()")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.batch, args.prompt_len, args.max_new,
                full_size=args.full_size, n_layers=args.n_layers,
                device=args.device)
    print(json.dumps({**{k: v for k, v in out.items()
                         if k not in ("tokens", "engine", "prompts",
                                      "frames", "patches")},
                      "first": out["tokens"][:2].tolist()}), flush=True)
    return out


if __name__ == "__main__":
    main()
