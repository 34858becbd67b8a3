"""Three-term roofline model of the *mapped fleet* from HLO analysis —
the port's copy of the JAX package's ``analysis/roofline.py``.

    compute term    = per-device FLOPs / peak FLOP/s
    memory term     = per-device HBM bytes / HBM bandwidth
    collective term = per-device ICI wire bytes / ICI bw
                      + per-device DCN wire bytes / DCN bw  (cross-pod)

All inputs come from :mod:`repro_torch.analysis.hlo` (per-device, trip-count
corrected).  The dominant term is the bottleneck; the roofline fraction of
an iso-FLOP ideal step is  compute / max(compute, memory, collective).

The constants below are a TPU v5e's.  They describe the fleet a mapping
is made *for* — the chips and links whose step time the closed loop's
replay gate (:mod:`repro_torch.monitor.replay`) predicts — and not the
card the port itself runs on; they are kept so that the port's replay
verdicts equal the reference's.  No time of the port is derived from
them.
"""

from __future__ import annotations

from dataclasses import dataclass

from .hlo import HloCost

# TPU v5e constants (per chip) of the mapped fleet — see the docstring.
PEAK_FLOPS_BF16 = 197e12        # FLOP/s
HBM_BW = 819e9                  # B/s
ICI_BW = 50e9                   # B/s per link; v5e has multiple links but we
                                # price conservatively at one link's worth
DCN_BW = 6.25e9                 # B/s per chip across pods (50 Gb/s NIC share)


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    ici_s: float
    dcn_s: float
    flops: float
    hbm_bytes: float
    ici_bytes: float
    dcn_bytes: float
    model_flops: float = 0.0      # analytic 6·N·D (set by caller)

    @property
    def collective_s(self) -> float:
        return self.ici_s + self.dcn_s

    @property
    def bound(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Lower bound on step time: perfect overlap → max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of ideal (compute-only) throughput this step can reach
        assuming perfect overlap: compute / max-term."""
        if self.step_time_s == 0:
            return 0.0
        return self.compute_s / self.step_time_s

    @property
    def model_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs (per-device-normalized by the caller):
        <1 means remat/redundant compute inflates the HLO."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def mfu_bound(self) -> float:
        """Upper bound on MFU: useful model FLOPs over peak during step_time."""
        if self.step_time_s == 0 or self.model_flops == 0:
            return 0.0
        return self.model_flops / (self.step_time_s * PEAK_FLOPS_BF16)

    def row(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "ici_s": self.ici_s, "dcn_s": self.dcn_s,
            "bound": self.bound, "step_time_s": self.step_time_s,
            "roofline_fraction": self.roofline_fraction,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "ici_bytes": self.ici_bytes, "dcn_bytes": self.dcn_bytes,
            "model_flops_ratio": self.model_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def roofline_from_cost(cost: HloCost, model_flops_per_device: float = 0.0,
                       peak_flops: float = PEAK_FLOPS_BF16,
                       hbm_bw: float = HBM_BW, ici_bw: float = ICI_BW,
                       dcn_bw: float = DCN_BW) -> Roofline:
    return Roofline(
        compute_s=cost.flops / peak_flops,
        memory_s=cost.hbm_bytes / hbm_bw,
        ici_s=cost.ici_bytes / ici_bw,
        dcn_s=cost.dcn_bytes / dcn_bw,
        flops=cost.flops,
        hbm_bytes=cost.hbm_bytes,
        ici_bytes=cost.ici_bytes,
        dcn_bytes=cost.dcn_bytes,
        model_flops=model_flops_per_device,
    )
