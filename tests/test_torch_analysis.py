"""Parity of repro_torch's analysis (`analysis/roofline.py`,
`analysis/flops.py`) with the JAX package's, on the CPU.

The HLO parser is a copy and is held to the reference on
tests/test_roofline.py's HLO text, exactly. `Roofline` under the TPU v5e
constants gives the reference's terms (to 1e-12 relative); under the H100
constants its terms are checked by hand. The parameter counts walk the
port's tree (`layers/<i>/...`) where the reference walks its stacked one
(`decoder/stack/pos<k>/...`), and equal the reference's for every
ported config, full width and smoke: for Qwen2-MoE-A2.7B 15,146,256,384
parameters in all and 1,288,275,968 active, the shared experts counted at
top_k / n_experts as the reference counts them; for Mamba2-2.7B
2,702,296,576 and for RecurrentGemma-2B 2,894,528,000.
"""
import pytest

from repro.analysis import flops as j_flops
from repro.analysis import roofline as j_roofline
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro_torch.analysis import flops, roofline
from repro_torch.analysis.roofline import (H100, V5E, Roofline, from_counts,
                                           model_flops)
from repro_torch.configs import REGISTRY, SMOKE_REGISTRY
from test_roofline import HLO

ARCHS = sorted(REGISTRY)
SHAPES = [dict(kind="train", batch=8, seq=4096),
          dict(kind="prefill", batch=4, seq=2048),
          dict(kind="decode", batch=64)]


@pytest.mark.parametrize("type_str", ["bf16[2,3]", "f32[10]",
                                      "(f32[2], bf16[4])", "pred[8]",
                                      "s32[]", "f8e4m3fn[3,3]", "token[]"])
def test_shape_bytes_matches_reference(type_str):
    assert roofline._shape_bytes(type_str) == \
        j_roofline._shape_bytes(type_str)


def test_parse_collectives_matches_reference():
    st, ref = roofline.parse_collectives(HLO), j_roofline.parse_collectives(
        HLO)
    assert st.counts == ref.counts
    assert st.operand_bytes == ref.operand_bytes
    assert st.per_chip_bytes == ref.per_chip_bytes
    assert st.total_operand_bytes == ref.total_operand_bytes
    assert st.total_per_chip_bytes == ref.total_per_chip_bytes
    assert st.counts["all-gather"] == 2
    assert st.operand_bytes["collective-permute"] == 4096


def test_v5e_constants_match_reference():
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW,
            roofline.ICI_LINK_BW) == (j_roofline.PEAK_FLOPS_BF16,
                                      j_roofline.HBM_BW,
                                      j_roofline.ICI_LINK_BW)


@pytest.mark.parametrize("terms", [(256, 2.0, 0.5), (8, 0.5, 3.0),
                                   (1, 0.1, 0.0)])
def test_v5e_roofline_matches_reference(terms):
    chips, mem, coll = terms
    args = dict(flops=197e12 * chips, hbm_bytes=819e9 * chips * mem,
                collective_bytes=50e9 * chips * coll,
                collective_per_chip=1e9, chips=chips)
    ref = j_roofline.Roofline(**args)
    r = Roofline(**args, chip=V5E)
    for f in ("compute_s", "memory_s", "collective_s", "bound_s"):
        assert getattr(r, f) == pytest.approx(getattr(ref, f), rel=1e-12)
    assert r.dominant == ref.dominant
    d, jd = r.as_dict(), ref.as_dict()
    assert d.pop("dominant") == jd.pop("dominant")
    for k in jd:
        assert d[k] == pytest.approx(jd[k], rel=1e-12), k


def test_h100_roofline_by_hand():
    # 1 ms of bf16 tensor-core work, 2 ms of HBM traffic on one card
    r = from_counts(flops=989e9, hbm_bytes=2 * 3.35e9)
    assert r.chip is H100 and r.chips == 1
    assert r.compute_s == pytest.approx(1e-3, rel=1e-12)
    assert r.memory_s == pytest.approx(2e-3, rel=1e-12)
    assert r.collective_s == 0.0
    assert r.dominant == "memory" and r.bound_s == pytest.approx(2e-3)
    f32 = from_counts(flops=67e9, hbm_bytes=0, dtype="float32")
    assert f32.compute_s == pytest.approx(1e-3) and f32.dominant == "compute"
    f64 = from_counts(flops=34e9, hbm_bytes=0, dtype="float64")
    assert f64.compute_s == pytest.approx(1e-3)
    with pytest.raises(ValueError, match="no peak"):
        from_counts(1.0, 1.0, dtype="int4").compute_s
    with pytest.raises(ValueError, match="link"):
        Roofline(1.0, 1.0, collective_bytes=8.0, chip=H100).collective_s


def test_model_flops_matches_reference():
    for train in (True, False):
        assert model_flops(1e9, 1e6, train=train) == \
            j_roofline.model_flops(1e9, 1e6, train=train)
    assert model_flops(1e9, 1e6) == pytest.approx(6e15)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_param_counts_match_reference(arch, smoke):
    cfg = (SMOKE_REGISTRY if smoke else REGISTRY)[arch]
    jcfg = (J_SMOKE if smoke else J_REGISTRY)[arch]
    for embed in (True, False):
        assert flops.total_params(cfg, embed) == \
            j_flops.total_params(jcfg, embed)
        assert flops.active_params(cfg, embed) == \
            j_flops.active_params(jcfg, embed)


def test_qwen2_moe_counts():
    """The reference's numbers, shared experts at top_k / n_experts
    (ROADMAP.md, Queue 3); counted in full they would add 4 shared MLPs x
    24 layers x (1 - 4/64)."""
    cfg = REGISTRY["qwen2-moe-a2.7b"]
    assert flops.total_params(cfg) == 15_146_256_384
    assert flops.active_params(cfg) == 1_288_275_968
    shared = 24 * 3 * cfg.d_model * cfg.n_shared_experts * cfg.expert_d_ff
    assert shared * (1 - cfg.top_k / cfg.n_experts) == pytest.approx(
        778.0e6, rel=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES, ids=[s["kind"] for s in SHAPES])
def test_model_flops_cell_matches_reference(arch, shape):
    assert flops.model_flops_cell(REGISTRY[arch], shape) == \
        j_flops.model_flops_cell(J_REGISTRY[arch], shape)


def test_model_flops_cell_by_hand():
    cfg = REGISTRY["qwen2-moe-a2.7b"]
    n = 1_288_275_968
    assert flops.model_flops_cell(cfg, SHAPES[0]) == 6.0 * n * 8 * 4096
    assert flops.model_flops_cell(cfg, SHAPES[1]) == 2.0 * n * 4 * 2048
    assert flops.model_flops_cell(cfg, SHAPES[2]) == 2.0 * n * 64


@pytest.mark.parametrize("arch,total,embed", [
    ("mamba2-2.7b", 2_702_296_576, 50_304 * 2560),
    ("recurrentgemma-2b", 2_894_528_000, 256_000 * 2560),
])
def test_recurrent_config_counts(arch, total, embed):
    """The reference's counts of the SSD and RG-LRU models (tied
    embeddings, no experts): every parameter is active, and the FLOP cells
    are 2 or 6 x the parameters past the embedding x the tokens."""
    cfg = REGISTRY[arch]
    assert flops.total_params(cfg) == total
    assert flops.total_params(cfg, include_embed=False) == total - embed
    assert flops.active_params(cfg) == total - embed
    assert flops.model_flops_cell(cfg, SHAPES[1]) == \
        2.0 * (total - embed) * 4 * 2048
    keys = [k for k, _ in flops._leaf_counts(cfg)]
    assert not any(flops._is_expert_weight(k) for k in keys)


def test_dense_config_has_no_expert_keys():
    cfg = REGISTRY["yi-6b"]
    keys = [k for k, _ in flops._leaf_counts(cfg)]
    assert keys[0] == "embed/tok" and keys[-1] == "final_norm"
    assert not any(flops._is_expert_weight(k) for k in keys)
    assert flops.active_params(cfg, True) == flops.total_params(cfg)
