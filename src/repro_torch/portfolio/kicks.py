"""Perturbation kicks on the device: bijective permutation perturbations
applied to every lane between portfolio rounds.

The port of the JAX package's ``portfolio/kicks.py``.  A kick must stay
a bijection (the refinement only ever swaps, so validity is preserved
downstream) and keep one shape whatever the draws.  Two perturbations
satisfy both:

* **segment reversal** — reverse a length-``klen`` window of the
  assignment array starting at a drawn position (wrapping around): it
  relocates a contiguous block of processes wholesale.
* **swap storm** — ``klen`` drawn transpositions applied in sequence, a
  diffuse shake that spreads displacement across the whole machine.

A drawn coin picks one of the two for each lane.

The JAX version draws from a threefry key inside its jitted round loop;
torch's Philox cannot repeat those streams, so the port's kick is a pure
function of explicit draws ``(s, uv, coin)``, which the portfolio
runner draws on the host before its round loop
(:func:`repro_torch.portfolio.search.kick_draws`) and uploads once.  Fed
the reference's own draws, the kick equals the reference's bit for bit.
"""

from __future__ import annotations

__all__ = ["kick_length", "make_kick"]


def kick_length(n: int, kick_frac: float) -> int:
    """Vertices a kick touches: ``round(kick_frac · n)``, at least 2 and
    at most ``n`` — the JAX package's ``klen``."""
    return max(2, min(n, int(round(kick_frac * n))))


def make_kick(n: int, kick_frac: float):
    """The kick ``(perms, s, uv, coin) -> perms`` for (L, n) lanes of
    ``n``-element permutations on one device: ``s`` (L,) window starts
    in [0, n), ``uv`` (L, klen, 2) transposition endpoints in [0, n),
    ``coin`` (L,) bool (true: the segment reversal, false: the swap
    storm).  ``kick.klen`` is :func:`kick_length`.  The input is not
    modified."""
    import torch

    klen = kick_length(n, kick_frac)

    def kick(perms, s, uv, coin):
        lanes = perms.shape[0]
        dev = perms.device
        idx = torch.arange(n, dtype=torch.long, device=dev)[None, :]
        s_ = s.long()[:, None]
        # segment reversal: positions s .. s+klen-1 (mod n) reversed;
        # offset o = (i - s) mod n maps to klen-1-o, i.e. source index
        # (2s + klen - 1 - i) mod n.  torch's % on integer tensors is
        # floor-mod (a non-negative result for n > 0), like jnp's
        in_seg = ((idx - s_) % n) < klen
        src = torch.where(in_seg, (2 * s_ + klen - 1 - idx) % n, idx)
        reversed_ = perms.gather(1, src)
        # swap storm: klen transpositions in sequence, every lane at once
        # over the flattened lanes (a u == v draw is the identity)
        base = (torch.arange(lanes, dtype=torch.long, device=dev)
                * n)[None, :]
        us = (uv[:, :, 0].long().T + base).contiguous()     # (klen, L)
        vs = (uv[:, :, 1].long().T + base).contiguous()
        storm = perms.clone()
        flat = storm.view(-1)
        for t in range(klen):
            pu = flat.index_select(0, us[t])
            pv = flat.index_select(0, vs[t])
            flat.index_copy_(0, us[t], pv)
            flat.index_copy_(0, vs[t], pu)
        return torch.where(coin[:, None], reversed_, storm)

    kick.klen = klen
    return kick
