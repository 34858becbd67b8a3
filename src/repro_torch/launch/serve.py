"""Serving driver: batched prefill + greedy decode loop with KV caches —
the LM half of the JAX package's ``launch/serve.py``.  The
fleet-placement ``MappingService`` and ``--placement-smoke`` wait for
ROADMAP item 4.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-8b \
        --smoke --device cpu

The prefill's attention is K4 on the card (its plain version on the
CPU).  The decode loop stays on the device: the next token is an argmax
on the device fed straight into the next step, and nothing is read back
to the host until the final ``tokens``.  On CUDA a second, untimed pass
of the loop runs inside a ``host_boundary`` scope, which counts the syncs
PyTorch sees there (``decode_syncs``).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config, get_smoke_config
from ..models.transformer import init_params, prefill_with_cache
from ..runtime.boundary import host_boundary
from ..runtime.device import resolve_device
from ..train.steps import serve_step

__all__ = ["make_prompts", "serve"]


def make_prompts(cfg, batch: int, prompt_len: int, seed: int, device):
    """(batch, prompt_len) int32 token ids, uniform over the vocabulary,
    from a generator seeded with ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device, dtype=torch.int32)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(arch: str, batch: int, prompt_len: int, gen: int,
          smoke: bool = False, seed: int = 0, device=None) -> dict:
    """Random weights and prompts from ``seed`` (both, as the JAX package
    uses one key for both), one prefill of ``batch`` prompts and ``gen``
    greedy tokens each.  Returns ``tokens`` (batch, gen) int32 on the
    device, ``prefill_s``, ``decode_s``, ``decode_tok_per_s`` and
    ``decode_syncs`` (None off CUDA)."""
    dev = resolve_device(device)
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    with torch.inference_mode():
        params = init_params(seed, cfg, device=dev)
        max_len = prompt_len + gen
        prompts = make_prompts(cfg, batch, prompt_len, seed, dev)

        _sync(dev)
        t0 = time.perf_counter()
        logits, caches = prefill_with_cache(params, prompts, cfg, max_len)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        del logits
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        def decode(tok):
            out = [tok]
            for i in range(gen - 1):
                tok, _ = serve_step(params, tok, caches, prompt_len + i, cfg)
                out.append(tok)
            return torch.cat(out, dim=1)

        t0 = time.perf_counter()
        tokens = decode(next_tok)
        _sync(dev)
        t_decode = time.perf_counter() - t0
        # the syncs are counted on a second pass of the same loop (same
        # steps, tokens discarded), so the debug mode that counts them
        # stays out of the timed pass
        with host_boundary("serve.decode", dev) as hb:
            if dev.type == "cuda":
                decode(next_tok)
        _sync(dev)
    return {
        "tokens": tokens,
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "decode_syncs": hb.syncs,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Prefill + greedy decode of a randomly initialised "
                    "dense LM on the port.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.batch, args.prompt_len, args.gen,
                smoke=args.smoke, seed=args.seed, device=args.device)
    print(f"prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_tok_per_s']:.1f} tok/s")
    print("sample:", out["tokens"][0, :12].tolist())


if __name__ == "__main__":
    main()
