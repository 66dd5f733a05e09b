"""repro_torch's data pipeline, checkpoints and training launcher on the
CPU.

* Data: `SyntheticTokens` (copied numpy) gives the JAX package's token
  stream bit for bit, and `make_batch` its tokens, frame embeddings
  (Whisper) and prefix embeddings (PaliGemma) bit for bit, in float32 and
  in bf16.
* Checkpoints: the JAX package's contract as tests/test_checkpoint.py
  checks it (round trip with dtypes kept, bf16 bit for bit; async save and
  wait; last-k retention; an incomplete checkpoint ignored; no checkpoint
  and a missing leaf raise), plus what the port adds: a snapshot taken at
  `save` (training goes on updating the tensors in place) and restore onto
  the template's dtype.
* The launcher: `launch.train.main` interrupted at a checkpoint and
  resumed gives the uninterrupted run's losses bit for bit, resuming from
  its final checkpoint or from a periodic one.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.configs import get_config as j_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.data.pipeline import make_batch as j_make_batch
from repro_torch.data import DataConfig, SyntheticTokens, make_batch
from repro_torch.launch import train
from repro_torch.models import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import tree_leaves

CPU = torch.device("cpu")


def _bits(a):
    """An array's raw bytes, bf16 (a JAX array or a tensor) included."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().tobytes()
        return a.numpy().tobytes()
    a = np.asarray(a)
    return a.view(np.uint16).tobytes() if a.dtype.name == "bfloat16" \
        else a.tobytes()


@pytest.mark.parametrize("kw", [dict(), dict(vocab_size=512, seq_len=64,
                                             global_batch=10, seed=7)])
def test_tokens_match_bit_for_bit(kw):
    ours, ref = SyntheticTokens(DataConfig(**kw)), JTokens(JDataConfig(**kw))
    assert dataclasses.asdict(DataConfig(**kw)) == \
        dataclasses.asdict(JDataConfig(**kw))
    np.testing.assert_array_equal(ours.unigram, ref.unigram)
    np.testing.assert_array_equal(ours.successor, ref.successor)
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    it, jit = ours.shard_iter(1, 2, start_step=3), ref.shard_iter(1, 2, 3)
    for _ in range(2):
        np.testing.assert_array_equal(next(it), next(jit))


@pytest.mark.parametrize("arch,smoke", [("whisper-base", True),
                                        ("paligemma-3b", True),
                                        ("smollm-360m", True),
                                        ("whisper-base", False)])
def test_make_batch_matches_bit_for_bit(arch, smoke):
    """Tokens, frames and prefixes from the seeds (seed, step, 7) and
    (seed, step, 11), in the config's compute dtype (float32 for the smoke
    configs, bf16 at full width)."""
    jcfg = J_SMOKE[arch] if smoke else j_get_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    kw = dict(vocab_size=cfg.vocab_size, seq_len=12, global_batch=2, seed=5)
    ours = make_batch(SyntheticTokens(DataConfig(**kw)), cfg, 3, CPU)
    ref = j_make_batch(JTokens(JDataConfig(**kw)), jcfg, 3)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert tuple(ours[key].shape) == tuple(ref[key].shape)
        assert _bits(ours[key]) == _bits(ref[key]), key
    assert ("enc_inputs" in ours) == cfg.is_encdec


# ------------------------------------------------------------ checkpoints --
def make_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.as_tensor(rng.standard_normal((4, 4)),
                                            dtype=torch.float32),
                       "b": torch.as_tensor(rng.standard_normal(4),
                                            dtype=torch.bfloat16),
                       "layers": [torch.zeros(3), torch.ones(2, 2)]},
            "opt": {"m": {"w": torch.zeros(4, 4), "b": torch.zeros(4)},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def assert_state_equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and _bits(x) == _bits(y)


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    state = make_state()
    mgr.save(10, state)
    restored, step = mgr.restore(make_state(seed=1))
    assert step == 10
    assert_state_equal(state, restored)
    assert restored["params"]["b"].dtype == torch.bfloat16
    manifest = json.loads((tmp_path / "step_00000010" /
                           "manifest.json").read_text())
    assert manifest["leaves"]["params/b"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["params/layers/1"]["shape"] == [2, 2]


def test_snapshot_at_save_and_template_dtype(tmp_path):
    """save copies the state before it returns (async too): an in-place
    update after it does not reach the checkpoint. restore casts each leaf
    to its template leaf's dtype."""
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    state = make_state()
    want = make_state()
    mgr.save(1, state)
    state["params"]["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore(make_state(seed=1))
    assert_state_equal(want, restored)
    template = make_state()
    template["params"]["w"] = template["params"]["w"].double()
    restored, _ = mgr.restore(template)
    assert restored["params"]["w"].dtype == torch.float64
    torch.testing.assert_close(restored["params"]["w"],
                               want["params"]["w"].double())


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    state = make_state()
    mgr.save(1, state)
    mgr.save(2, state)
    mgr.wait()
    assert mgr.latest_step() in (1, 2)  # depth-1 queue may supersede


def test_last_k_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, make_state())
    assert mgr.all_steps() == [3, 4]


def test_incomplete_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3, async_write=False)
    mgr.save(5, make_state())
    # a crash mid-write: a directory without manifest, and a .tmp one
    broken = tmp_path / "step_00000009"
    broken.mkdir()
    (broken / "arr_00000.npy").write_bytes(b"garbage")
    (tmp_path / "step_00000011.tmp").mkdir()
    assert mgr.latest_step() == 5
    _, step = mgr.restore(make_state(seed=2))
    assert step == 5


def test_restore_missing_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    with pytest.raises(FileNotFoundError):
        mgr.restore(make_state())
    mgr.save(3, make_state())
    template = make_state()
    template["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        mgr.restore(template)


# -------------------------------------------------------------- launcher --
ARGS = ["--arch", "smollm-360m", "--smoke", "--device", "cpu", "--batch",
        "2", "--seq", "16", "--log-every", "100"]


def test_resume_repeats_uninterrupted_run(tmp_path):
    """Six steps at once against three then three from the final
    checkpoint, and against a run whose newest checkpoint is lost, resumed
    from a periodic one (step 4 of --ckpt-every 2): the same losses, bit
    for bit."""
    full = train.main(ARGS + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a"), "--ckpt-every", "2"])
    assert len(full) == 6 and full[-1] < full[0]
    first = train.main(ARGS + ["--steps", "3", "--ckpt-dir",
                               str(tmp_path / "b")])
    rest = train.main(ARGS + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "b")])
    assert first + rest == full
    mgr = CheckpointManager(tmp_path / "a", async_write=False)
    assert mgr.all_steps() == [2, 4, 6]
    for f in (tmp_path / "a" / "step_00000006").iterdir():
        f.unlink()
    (tmp_path / "a" / "step_00000006").rmdir()
    assert train.main(ARGS + ["--steps", "6", "--ckpt-dir",
                              str(tmp_path / "a")]) == full[4:]


def test_loss_tol_monitor_stops(capsys):
    """A loss tolerance above every step's change stops the run after the
    persistence counter's 5 agreeing checks (the paper's Fig. 1 protocol
    on the loss)."""
    losses = train.main(ARGS + ["--steps", "20", "--loss-tol", "1e3"])
    assert len(losses) == 6
    assert "persistent convergence at step 5" in capsys.readouterr().out
