"""Roofline terms of a step, and the HLO collective parser (the JAX
package's analysis/roofline.py).

    compute term    = FLOPs / (chips * peak FLOP/s of the dtype)
    memory term     = HBM bytes / (chips * HBM bytes/s)
    collective term = collective bytes / (chips * link bytes/s)

The JAX package reads FLOPs and bytes from a compiled XLA program
(`from_compiled`, over `compiled.cost_analysis()`); the port has no
compiled program to read, so `from_counts` takes the counts as arguments,
as the caller computes them from shapes. `parse_collectives` (the operand
bytes of every collective in post-SPMD HLO text) is plain Python and is
copied as it is.

Hardware constants: the JAX package's TPU v5e (kept under its names:
PEAK_FLOPS_BF16, HBM_BW, ICI_LINK_BW) and the NVIDIA H100 SXM the port runs
on (NVIDIA's data sheet, dense rates at the 700 W limit). `Roofline` takes
the chip; one H100 has no collective term.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

# --- v5e hardware constants (per chip) ---
PEAK_FLOPS_BF16 = 197e12        # FLOP/s
HBM_BW = 819e9                  # B/s
ICI_LINK_BW = 50e9              # B/s per link

# --- H100 SXM hardware constants (per card) ---
H100_HBM_BW = 3.35e12           # B/s, HBM3
H100_PEAK_FLOPS = {
    "bfloat16": 989e12,         # dense, tensor cores
    "tfloat32": 495e12,         # dense, tensor cores
    "float32": 67e12,           # outside the tensor cores
    "float64": 34e12,           # outside the tensor cores
}


@dataclasses.dataclass(frozen=True)
class Chip:
    """Peak rates of one chip: FLOP/s by dtype, HBM bytes/s, and the
    inter-chip link's bytes/s (None: no link model)."""
    name: str
    peak_flops: Mapping[str, float]
    hbm_bw: float
    link_bw: Optional[float]


V5E = Chip("tpu-v5e", {"bfloat16": PEAK_FLOPS_BF16}, HBM_BW, ICI_LINK_BW)
H100 = Chip("h100-sxm", H100_PEAK_FLOPS, H100_HBM_BW, None)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# `%name = bf16[1,2,3]{...} op-name(...)` | tuple results `(f32[..], ..)`
_DEF_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w\.\-]+)\s*=\s*(\(?[a-z0-9_]+\[[^=]*?)\s+"
    r"([\w\-]+)\((.*)$", re.M)
_SHAPE_RE = re.compile(r"([a-z0-9_]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9, ]+)\}")
_OPERAND_RE = re.compile(r"%?([\w\.\-]+)")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


@dataclasses.dataclass
class CollectiveStats:
    operand_bytes: Dict[str, int]
    per_chip_bytes: Dict[str, int]   # refined ring-model estimate
    counts: Dict[str, int]

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_per_chip_bytes(self) -> int:
        return sum(self.per_chip_bytes.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    sizes: Dict[str, int] = {}
    operand_bytes = {c: 0 for c in _COLLECTIVES}
    per_chip = {c: 0 for c in _COLLECTIVES}
    counts = {c: 0 for c in _COLLECTIVES}

    for m in _DEF_RE.finditer(hlo_text):
        name, type_str, op, args = m.groups()
        nbytes = _shape_bytes(type_str)
        sizes[name] = nbytes
        base = op.split(".")[0]
        if base.endswith("-start"):
            base = base[:-6]
        if base.endswith("-done"):
            continue  # counted at -start
        if base not in _COLLECTIVES:
            continue
        counts[base] += 1

        # group size from replica_groups (first group)
        g = _GROUPS_RE.search(args)
        n = len(g.group(1).split(",")) if g else 1

        # operand sizes (resolve via symbol table; fall back to result size).
        # operands live before the closing paren of the op call; config
        # attributes (replica_groups=..., channel_id=...) come after.
        operand_str = args.split(")")[0]
        op_bytes = 0
        for om in _OPERAND_RE.finditer(operand_str):
            nm = om.group(1)
            if nm in sizes:
                op_bytes += sizes[nm]
        if op_bytes == 0:
            op_bytes = nbytes

        operand_bytes[base] += op_bytes
        if base == "all-reduce":
            per_chip[base] += int(2 * op_bytes * (n - 1) / max(n, 1))
        elif base == "all-gather":
            per_chip[base] += int(nbytes * (n - 1) / max(n, 1))
        elif base == "reduce-scatter":
            per_chip[base] += int(op_bytes * (n - 1) / max(n, 1))
        elif base == "all-to-all":
            per_chip[base] += int(op_bytes * (n - 1) / max(n, 1))
        else:  # collective-permute
            per_chip[base] += op_bytes

    return CollectiveStats(operand_bytes=operand_bytes,
                           per_chip_bytes=per_chip, counts=counts)


@dataclasses.dataclass
class Roofline:
    """The three terms of one step on `chips` chips of kind `chip`, the
    compute term at `chip`'s peak for `dtype`. The field order is the JAX
    package's; `chip` and `dtype` come last."""
    flops: float
    hbm_bytes: float
    collective_bytes: float = 0.0    # operand-sum (assignment definition)
    collective_per_chip: float = 0.0  # refined estimate
    chips: int = 1
    chip: Chip = H100
    dtype: str = "bfloat16"

    @property
    def peak_flops(self) -> float:
        if self.dtype not in self.chip.peak_flops:
            raise ValueError(f"{self.chip.name} has no peak for "
                             f"{self.dtype!r}; have "
                             f"{sorted(self.chip.peak_flops)}")
        return self.chip.peak_flops[self.dtype]

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * self.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / (self.chips * self.chip.hbm_bw)

    @property
    def collective_s(self) -> float:
        if not self.collective_bytes:
            return 0.0
        if self.chip.link_bw is None:
            raise ValueError(f"{self.chip.name}: no inter-chip link model "
                             f"for {self.collective_bytes} collective bytes")
        return self.collective_bytes / (self.chips * self.chip.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return dict(
            flops=self.flops, hbm_bytes=self.hbm_bytes,
            collective_bytes=self.collective_bytes,
            collective_per_chip=self.collective_per_chip,
            chips=self.chips, chip=self.chip.name, dtype=self.dtype,
            compute_s=self.compute_s, memory_s=self.memory_s,
            collective_s=self.collective_s, dominant=self.dominant)


def model_flops(n_params_active: int, n_tokens: int,
                train: bool = True) -> float:
    """6*N*D (train fwd+bwd) or 2*N*D (inference forward)."""
    return (6.0 if train else 2.0) * n_params_active * n_tokens


def from_counts(flops: float, hbm_bytes: float, chip: Chip = H100,
                dtype: str = "bfloat16") -> Roofline:
    """The roofline of one step on one chip from its FLOPs and HBM bytes
    (the JAX package's `from_compiled` reads them from a compiled XLA
    program instead)."""
    return Roofline(flops=float(flops), hbm_bytes=float(hbm_bytes),
                    chips=1, chip=chip, dtype=dtype)
