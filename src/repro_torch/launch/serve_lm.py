"""LM serving demo: batched prefill + decode loop, on the port.

Counterpart of `repro.launch.serve_lm` (CUDA unless ``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-7b \
        --batch 4 --prompt-len 32 --gen 16 [--smoke] [--device cpu]

Greedy decode through `launch.steps.make_serve_step` with the ring-buffer
KV cache (or the recurrent state of the SSM/hybrid archs; an enc-dec
arch's cross-attention cache is primed from random frames first). The
prompt is prefilled token by token through the decode path. The clock
stops after the card has finished. The social-prediction serving front
end lives in `repro_torch.launch.serve`.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.social import seeded_generator
from repro_torch.device import shape_device, synchronize
from repro_torch.launch import steps
from repro_torch.models import build_model

__all__ = ["serve", "main"]


def serve(arch: str, *, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          cache_len: int = 128, smoke: bool = True, seed: int = 0,
          device: str = "cuda") -> dict:
    """Generate ``gen`` tokens after random prompts; returns ``{"tokens"
    (batch, 1 + gen) numpy: the first prompt token, then the generated
    ones, "seconds"}``."""
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.reduced()
    model = build_model(cfg, device)
    dev = shape_device(device)
    # independent randomness for params, prompts and priming frames —
    # reusing one seed would correlate the weights with the inputs
    params = model.init(seeded_generator(dev, seed, 0))
    prompt_gen = seeded_generator(dev, seed, 1)
    serve_step = steps.make_serve_step(model)

    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                            generator=prompt_gen, device=dev,
                            dtype=torch.int32)
    cache = model.init_cache(batch, cache_len)
    if model.prime_cache is not None:
        frames = torch.randn((batch, max(cache_len // 4, 8), cfg.d_model),
                             generator=seeded_generator(dev, seed, 2),
                             device=dev)
        with torch.no_grad():
            cache = model.prime_cache(params, cache, frames.to(cfg.tdtype))

    # prefill token-by-token through the decode path (fills cache + state)
    synchronize(dev)
    t0 = time.perf_counter()
    tok = prompts[:, :1]
    out_tokens = [tok]
    for i in range(prompt_len - 1):
        pos = torch.full((batch,), i, dtype=torch.int32, device=dev)
        _, cache = serve_step(params, cache, tok, pos)
        tok = prompts[:, i + 1: i + 2]
    # generate
    for i in range(gen):
        pos = torch.full((batch,), prompt_len - 1 + i, dtype=torch.int32,
                         device=dev)
        nxt, cache = serve_step(params, cache, tok, pos)
        tok = nxt[:, None]
        out_tokens.append(tok)
    synchronize(dev)            # honest wall clock: wait for the card
    dt = time.perf_counter() - t0
    toks = torch.cat(out_tokens, dim=1).cpu().numpy()
    print(f"{arch}: generated {gen} tokens x batch {batch} in {dt:.2f}s "
          f"({(prompt_len + gen - 1) / dt:.1f} steps/s)")
    print("sample token ids:", toks[0, -min(gen, 10):].tolist())
    return {"tokens": np.asarray(toks), "seconds": dt}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve_lm",
        description="greedy LM decode on the port")
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (default: the CUDA card)")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    return serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                 gen=args.gen, cache_len=args.cache_len, smoke=args.smoke,
                 seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
