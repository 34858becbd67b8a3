"""Post-optimization HLO text analyzer: FLOPs, HBM traffic, collective bytes
— the port's copy of the JAX package's ``analysis/hlo.py`` (verbatim but
for this note; it reads text and imports neither jax nor torch).

Why not ``compiled.cost_analysis()``: on XLA's CPU backend it reports
per-partition numbers (fine) but counts ``while`` (scan) bodies **once**
regardless of trip count — a 56-layer scanned transformer would be
under-counted 56×.  This module parses ``compiled.as_text()`` and:

  * multiplies instruction costs by loop trip counts (``backend_config``
    known_trip_count when present, else the max s32 constant in the while's
    condition computation — scans lower to `i < N` conditions),
  * computes dot FLOPs exactly from shapes + contracting dims
    (2 · numel(out) · Π contracted), elementwise/reduce ops at 1 FLOP/elem,
  * approximates HBM traffic as Σ (operand + result bytes) of *top-level*
    instructions — instructions inside fusion computations don't touch HBM,
  * prices collectives with ring-algorithm wire factors and replica-group
    sizes parsed from both iota (``[32,16]<=[512]``, with optional
    transpose suffix) and explicit-list syntax, and splits traffic into
    intra-pod (ICI) vs cross-pod (DCN) given a pod size.

All shapes in SPMD-partitioned HLO are per-device, so every number here is
per-device — exactly what the roofline terms need.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "token": 0, "opaque": 0, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(\([^)]*\)|\S+)\s+([\w\-]+)\((.*)$")
_COMP_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s+\(.*\)\s*->\s*.*\{\s*$")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)

# opcodes that don't move HBM bytes at top level
_FREE_OPS = {
    "parameter", "constant", "get-tuple-element", "tuple", "bitcast",
    "after-all", "while", "conditional", "call", "iota", "rng-get-and-update-state",
    "partition-id", "replica-id", "domain", "opt-barrier",
}

# elementwise/shape ops that TPU XLA fuses into neighboring producers/
# consumers — their traffic is accounted by the ops they fuse into.  The
# CPU backend (our dry-run host) leaves many of these unfused at top level;
# counting them would overstate TPU HBM traffic by ~10×.
_FUSED_FREE_OPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "exponential", "exponential-minus-one", "log", "log-plus-one", "tanh",
    "negate", "abs", "sign", "cosine", "sine", "sqrt", "rsqrt", "cbrt",
    "compare", "select", "and", "or", "xor", "not", "clamp", "convert",
    "broadcast", "reshape", "floor", "ceil", "round-nearest-afz",
    "round-nearest-even", "is-finite", "reduce-precision", "atan2",
    "shift-left", "shift-right-logical", "shift-right-arithmetic",
    "stochastic-convert", "erf", "logistic", "remainder", "rem",
}


def shape_numel_bytes(shape_str: str) -> tuple[int, int]:
    """(numel, bytes) of a shape string; tuples summed (numel of first part)."""
    total_b = 0
    total_n = 0
    for dt, dims in _SHAPE_RE.findall(shape_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total_n += n
        total_b += n * _DTYPE_BYTES[dt]
    return total_n, total_b


@dataclass
class Instruction:
    name: str
    shape: str
    opcode: str
    rest: str           # operand list + attributes (raw tail of the line)

    def attr(self, key: str) -> str | None:
        m = re.search(key + r"=(\{[^}]*\}|\[[^\]]*\][^,]*|[^,\s]+)", self.rest)
        return m.group(1) if m else None

    @property
    def operands(self) -> list[str]:
        # operands are the %refs before the first '), ' attribute boundary
        depth = 0
        end = len(self.rest)
        for i, ch in enumerate(self.rest):
            if ch == "(":
                depth += 1
            elif ch == ")":
                if depth == 0:
                    end = i
                    break
                depth -= 1
        return _OPERAND_RE.findall(self.rest[:end])


@dataclass
class Computation:
    name: str
    instructions: list[Instruction] = field(default_factory=list)
    symbols: dict = field(default_factory=dict)  # name -> shape str


@dataclass
class CollectiveStat:
    op: str
    wire_bytes: float = 0.0      # ring-priced per-device wire traffic
    raw_bytes: float = 0.0       # operand bytes × multiplier
    count: float = 0.0
    group_size: int = 1
    cross_pod: bool = False
    ici_wire: float = 0.0        # hierarchical decomposition (DESIGN §4):
    dcn_wire: float = 0.0        # RS-in-pod → AR-across-pods → AG-in-pod


@dataclass
class HloCost:
    """Per-device cost model extracted from optimized HLO."""
    flops: float = 0.0                 # total (dot + elementwise)
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    collectives: list = field(default_factory=list)
    trip_counts: dict = field(default_factory=dict)

    @property
    def ici_bytes(self) -> float:
        return sum(c.ici_wire for c in self.collectives)

    @property
    def dcn_bytes(self) -> float:
        return sum(c.dcn_wire for c in self.collectives)

    @property
    def collective_bytes(self) -> float:
        return sum(c.wire_bytes for c in self.collectives)

    def by_type(self) -> dict:
        agg: dict = defaultdict(float)
        for c in self.collectives:
            agg[c.op] += c.wire_bytes
        return dict(agg)


# ---------------------------------------------------------------- parsing
def parse_module(hlo_text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    entry_name = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not stripped or stripped.startswith(("HloModule", "//", "#")):
            continue
        m = _COMP_RE.match(stripped)
        if m and stripped.endswith("{"):
            cur = Computation(m.group(1))
            comps[cur.name] = cur
            if stripped.startswith("ENTRY"):
                entry_name = cur.name
            continue
        if stripped == "}" or stripped.startswith("}"):
            cur = None
            continue
        mi = _INSTR_RE.match(line)
        if mi and cur is not None:
            ins = Instruction(name=mi.group(1), shape=mi.group(2),
                              opcode=mi.group(3), rest=mi.group(4))
            cur.instructions.append(ins)
            cur.symbols[ins.name] = ins.shape
    if entry_name is not None:
        comps["__entry__"] = comps[entry_name]
    return comps


def _find_trip_count(while_ins: Instruction,
                     comps: dict[str, Computation]) -> int:
    bc = re.search(r'known_trip_count[":{\s]+n["\s:]+(\d+)', while_ins.rest)
    if bc:
        return int(bc.group(1))
    cond = re.search(r"condition=%?([\w.\-]+)", while_ins.rest)
    if cond and cond.group(1) in comps:
        best = 1
        for ins in comps[cond.group(1)].instructions:
            if ins.opcode == "constant" and ins.shape.startswith(("s32", "u32", "s64")):
                m = re.match(r"\s*(\d+)", ins.rest)
                if m:
                    best = max(best, int(m.group(1)))
        return best
    return 1


def _replica_group_info(ins: Instruction, pod_size: int | None
                        ) -> tuple[int, int]:
    """(group size, pods spanned) from the replica_groups attr."""
    rest = ins.rest

    def pods_of(groups):
        if not pod_size:
            return 1
        best = 1
        for grp in groups:
            best = max(best, len({i // pod_size for i in grp}))
        return best

    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](T\(([\d,]+)\))?",
                  rest)
    if m:
        n_groups, g_size = int(m.group(1)), int(m.group(2))
        shape = tuple(int(d) for d in m.group(3).split(","))
        ids = np.arange(int(np.prod(shape))).reshape(shape)
        if m.group(5):
            ids = ids.transpose(tuple(int(d) for d in m.group(5).split(",")))
        groups = ids.reshape(n_groups, g_size)
        return g_size, pods_of(groups.tolist())
    mg = re.search(r"replica_groups=\{(\{[\d,]+\}(?:,\{[\d,]+\})*)\}", rest)
    if mg:
        groups = [[int(x) for x in grp.split(",")]
                  for grp in re.findall(r"\{([\d,]+)\}", mg.group(1))]
        return len(groups[0]), pods_of(groups)
    if "source_target_pairs" in rest:
        pairs = re.findall(r"\{(\d+),(\d+)\}", rest)
        cross = pod_size and any(
            int(a) // pod_size != int(b) // pod_size for a, b in pairs)
        return 2, 2 if cross else 1
    return 2, 1


def _ring_factor(op: str, g: int) -> float:
    """Per-device wire bytes per operand byte under ring algorithms."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2.0 * (g - 1) / g
    if op == "all-gather":
        return float(g - 1)          # operand is the local shard
    if op in ("reduce-scatter", "all-to-all", "ragged-all-to-all"):
        return (g - 1) / g           # operand is the full local buffer
    if op == "collective-broadcast":
        return 1.0
    return 1.0                       # collective-permute


def _dot_flops(ins: Instruction, symbols: dict) -> float:
    out_numel, _ = shape_numel_bytes(ins.shape)
    ops = ins.operands
    if not ops:
        return 0.0
    lhs_shape = symbols.get(ops[0], "")
    mdims = _SHAPE_RE.search(lhs_shape)
    if not mdims:
        return 0.0
    dims = [int(d) for d in mdims.group(2).split(",")] if mdims.group(2) else []
    mc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.rest)
    k = 1
    if mc and mc.group(1):
        for d in mc.group(1).split(","):
            k *= dims[int(d)] if int(d) < len(dims) else 1
    return 2.0 * out_numel * k


def _hbm_traffic(ins: Instruction, comp: Computation,
                 comps: dict, out_bytes: int) -> float:
    """HBM bytes for one top-level instruction.

    In-place slice updates (dynamic-update-slice, and fusions rooted in
    one — scan-carry saves, KV-cache writes) move only the slice, not the
    whole buffer; XLA aliases the big operand.  Dynamic-slice reads only
    the slice.  Everything else: operands + output."""
    op = ins.opcode
    if op == "dynamic-update-slice":
        upd = shape_numel_bytes(
            comp.symbols.get(ins.operands[1], ""))[1] if len(
                ins.operands) > 1 else out_bytes
        return 2.0 * upd
    if op == "dynamic-slice":
        return 2.0 * out_bytes
    if op == "fusion":
        mm = re.search(r"calls=%?([\w.\-]+)", ins.rest)
        called = comps.get(mm.group(1)) if mm else None
        if called is not None and called.instructions:
            root = called.instructions[-1]
            if root.opcode == "dynamic-update-slice":
                # traffic = small operands of the fusion + 2× slice size
                big = max((shape_numel_bytes(
                    comp.symbols.get(o, ""))[1] for o in ins.operands),
                    default=0)
                upd = shape_numel_bytes(
                    called.symbols.get(root.operands[1], ""))[1] if len(
                        root.operands) > 1 else 0
                operand_bytes = sum(
                    shape_numel_bytes(comp.symbols.get(o, ""))[1]
                    for o in ins.operands)
                return (operand_bytes - big) + 2.0 * max(upd, 1)
    operand_bytes = sum(
        shape_numel_bytes(comp.symbols.get(o, ""))[1]
        for o in ins.operands)
    return operand_bytes + out_bytes


def analyze(hlo_text: str, pod_size: int | None = None) -> HloCost:
    """Analyze optimized (post-SPMD) HLO text into a per-device HloCost."""
    comps = parse_module(hlo_text)
    entry = comps.get("__entry__")
    if entry is None:
        raise ValueError("no ENTRY computation found")

    # ---- call multipliers + HBM-level flags ------------------------------
    mult: dict[str, float] = defaultdict(float)
    hbm_level: dict[str, bool] = defaultdict(bool)
    trip_counts: dict[str, int] = {}
    stack = [(entry.name, 1.0, True)]
    seen_edges = set()
    while stack:
        cname, m, hbm = stack.pop()
        mult[cname] += m
        hbm_level[cname] = hbm_level[cname] or hbm
        comp = comps.get(cname)
        if comp is None:
            continue
        for ins in comp.instructions:
            edge_key = (cname, ins.name)
            if edge_key in seen_edges:
                continue
            seen_edges.add(edge_key)
            if ins.opcode == "while":
                tc = _find_trip_count(ins, comps)
                trip_counts[ins.name] = tc
                for role in ("body", "condition"):
                    mm = re.search(role + r"=%?([\w.\-]+)", ins.rest)
                    if mm and mm.group(1) in comps:
                        stack.append((mm.group(1), m * tc, hbm))
            elif ins.opcode == "conditional":
                for mm in re.finditer(
                        r"(?:true_computation|false_computation|branch_computations=\{[^}]*)"
                        r"=?%?([\w.\-]+)", ins.rest):
                    if mm.group(1) in comps:
                        stack.append((mm.group(1), m, hbm))
            else:
                mm = re.search(r"calls=%?([\w.\-]+)", ins.rest)
                if mm and mm.group(1) in comps:
                    # fusion internals: flops counted, HBM not
                    stack.append((mm.group(1), m, False))
                mm = re.search(r"to_apply=%?([\w.\-]+)", ins.rest)
                if mm and mm.group(1) in comps:
                    stack.append((mm.group(1), m, False))

    cost = HloCost(trip_counts=trip_counts)
    coll_agg: dict[tuple, CollectiveStat] = {}

    for cname, comp in comps.items():
        if cname == "__entry__":
            continue
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        hbm = hbm_level.get(cname, False)
        for ins in comp.instructions:
            op = ins.opcode
            out_numel, out_bytes = shape_numel_bytes(ins.shape)
            # ---- flops
            if op == "dot":
                f = _dot_flops(ins, comp.symbols)
                cost.flops += m * f
                cost.dot_flops += m * f
            elif op == "convolution":
                # rare in our models; approximate via output * kernel numel
                kshape = comp.symbols.get(ins.operands[1], "") if len(
                    ins.operands) > 1 else ""
                kn, _ = shape_numel_bytes(kshape)
                cost.flops += m * 2.0 * out_numel * max(kn, 1) ** 0.5
            elif op in ("reduce", "reduce-window"):
                in_numel = shape_numel_bytes(
                    comp.symbols.get(ins.operands[0], ""))[0] if ins.operands \
                    else out_numel
                cost.flops += m * in_numel
            elif op == "fusion":
                pass  # internals counted in the called computation
            elif op not in _FREE_OPS and not op.startswith(
                    tuple(COLLECTIVE_OPS)):
                cost.flops += m * out_numel  # 1 flop/elem estimate
            # ---- HBM bytes (top level only, skip free + fusable ops)
            if hbm and op not in _FREE_OPS and op not in _FUSED_FREE_OPS:
                cost.hbm_bytes += m * _hbm_traffic(ins, comp, comps,
                                                   out_bytes)
            # ---- collectives (count the -start of async pairs, skip -done)
            base_op = op.replace("-start", "")
            if base_op in COLLECTIVE_OPS and not op.endswith("-done"):
                operand_bytes = sum(
                    shape_numel_bytes(comp.symbols.get(o, ""))[1]
                    for o in ins.operands) or out_bytes
                g, pods = _replica_group_info(ins, pod_size)
                cross = pods > 1
                # hierarchical decomposition: groups spanning pods run as
                # RS-within-pod → cross-pod phase → AG-within-pod (what
                # multi-slice XLA actually emits); the cross-pod phase
                # per-chip bytes amortize over the pod-local members.
                members = max(1, g // pods)
                if cross:
                    ici = _ring_factor(base_op, members) * operand_bytes
                    dcn = (_ring_factor(base_op, pods) * operand_bytes
                           / members)
                    if base_op == "all-gather":
                        # shard s: AG-in-pod (m−1)·s; cross-pod each chip
                        # forwards its pod's slice share: (P−1)·s
                        ici = (members - 1) * operand_bytes
                        dcn = (pods - 1) * operand_bytes
                else:
                    ici = _ring_factor(base_op, g) * operand_bytes
                    dcn = 0.0
                wire = ici + dcn
                key = (base_op, g, cross)
                st = coll_agg.setdefault(
                    key, CollectiveStat(op=base_op, group_size=g,
                                        cross_pod=cross))
                st.wire_bytes += m * wire
                st.raw_bytes += m * operand_bytes
                st.count += m
                st.ici_wire += m * ici
                st.dcn_wire += m * dcn

    cost.collectives = list(coll_agg.values())
    return cost


# ------------------------------------------------- materialized collectives
def _materialize_groups(ins: Instruction) -> list[list[int]] | None:
    """Full replica-group membership for a collective instruction."""
    rest = ins.rest
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](T\(([\d,]+)\))?",
                  rest)
    if m:
        n_groups, g_size = int(m.group(1)), int(m.group(2))
        shape = tuple(int(d) for d in m.group(3).split(","))
        ids = np.arange(int(np.prod(shape))).reshape(shape)
        if m.group(5):
            ids = ids.transpose(tuple(int(d) for d in m.group(5).split(",")))
        return ids.reshape(n_groups, g_size).tolist()
    mg = re.search(r"replica_groups=\{(\{[\d,]+\}(?:,\{[\d,]+\})*)\}", rest)
    if mg:
        return [[int(x) for x in grp.split(",")]
                for grp in re.findall(r"\{([\d,]+)\}", mg.group(1))]
    if "source_target_pairs" in rest:
        pairs = re.findall(r"\{(\d+),(\d+)\}", rest)
        return [[int(a), int(b)] for a, b in pairs]
    return None


def collective_instances(hlo_text: str):
    """Yield (op, groups, operand_bytes, multiplier) for every collective in
    the module, with while-loop multipliers applied — the input to the
    VieM communication-graph extraction (core.comm_model)."""
    comps = parse_module(hlo_text)
    entry = comps.get("__entry__")
    if entry is None:
        return
    mult: dict[str, float] = defaultdict(float)
    stack = [(entry.name, 1.0)]
    seen = set()
    while stack:
        cname, m = stack.pop()
        mult[cname] += m
        comp = comps.get(cname)
        if comp is None:
            continue
        for ins in comp.instructions:
            key = (cname, ins.name)
            if key in seen:
                continue
            seen.add(key)
            if ins.opcode == "while":
                tc = _find_trip_count(ins, comps)
                for role in ("body", "condition"):
                    mm = re.search(role + r"=%?([\w.\-]+)", ins.rest)
                    if mm and mm.group(1) in comps:
                        stack.append((mm.group(1), m * tc))
            else:
                for attr in ("calls", "to_apply"):
                    mm = re.search(attr + r"=%?([\w.\-]+)", ins.rest)
                    if mm and mm.group(1) in comps:
                        stack.append((mm.group(1), m))

    for cname, comp in comps.items():
        if cname == "__entry__":
            continue
        m = mult.get(cname, 0.0)
        if m == 0.0:
            continue
        for ins in comp.instructions:
            base_op = ins.opcode.replace("-start", "")
            if base_op in COLLECTIVE_OPS and not ins.opcode.endswith("-done"):
                groups = _materialize_groups(ins)
                if groups is None:
                    continue
                operand_bytes = sum(
                    shape_numel_bytes(comp.symbols.get(o, ""))[1]
                    for o in ins.operands) or shape_numel_bytes(ins.shape)[1]
                yield base_op, groups, operand_bytes, m
