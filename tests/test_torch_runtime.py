"""The port's training runtime: the behaviours of the reference's
``tests/test_runtime.py`` (``TestPipeline``, ``TestCheckpoint``,
``TestTrainerFT``) on ``repro_torch``, plus the copy of the data pipeline
and the checkpoint layout held to the reference package's: a checkpoint
written by either package restores in the other.  Everything runs on the
CPU at the granite_3_2b / mamba2_370m smoke configs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.sharded import CheckpointManager as RefCheckpoints
from repro.data import pipeline as ref_pipeline
from repro.runtime import train as ref_rt
from repro_torch.checkpoint.sharded import CheckpointManager
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import (DataConfig, FileSource, Pipeline,
                                       write_token_file)
from repro_torch.runtime import train as rt

ARCH = "granite_3_2b"


def small_cfg(arch=ARCH):
    return get_config(arch, smoke=True)


def data_cfg(cfg, batch=4, seq=32):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                      global_batch=batch, seed=7)


# ================================================================= data

class TestPipeline:
    def test_deterministic_and_resumable(self):
        cfg = small_cfg()
        b1 = Pipeline(data_cfg(cfg)).batch_at(13)
        b2 = Pipeline(data_cfg(cfg)).batch_at(13)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        assert b1["tokens"].shape == (4, 32)
        np.testing.assert_array_equal(b1["targets"][:, :-1],
                                      b1["tokens"][:, 1:])

    def test_replica_sharding_disjoint_and_covering(self):
        cfg = small_cfg()
        base = data_cfg(cfg, batch=8)
        full = Pipeline(base).batch_at(3)["tokens"]
        parts = []
        for r in range(4):
            dc = DataConfig(**{**base.__dict__, "n_replicas": 4,
                               "replica_id": r})
            parts.append(Pipeline(dc).batch_at(3)["tokens"])
        np.testing.assert_array_equal(np.concatenate(parts), full)

    def test_file_source_roundtrip(self, tmp_path):
        toks = np.arange(10_000, dtype=np.int32) % 97
        path = tmp_path / "corpus.bin"
        write_token_file(path, toks)
        dc = DataConfig(vocab_size=97, seq_len=32, global_batch=4,
                        path=str(path))
        batch = Pipeline(dc).batch_at(0)
        assert batch["tokens"].shape == (4, 32)
        diffs = np.diff(batch["tokens"][0].astype(np.int64)) % 97
        assert (diffs == 1).all()
        assert isinstance(Pipeline(dc).source, FileSource)

    @pytest.mark.parametrize("source", ["synthetic", "file"])
    def test_copy_gives_the_reference_batches(self, source, tmp_path):
        """The port's copy of ``data/pipeline.py`` gives the reference's
        batches, replica slices included."""
        path = None
        if source == "file":
            path = str(tmp_path / "corpus.bin")
            write_token_file(path, np.random.default_rng(1).integers(
                0, 257, 5000))
        kw = dict(vocab_size=257, seq_len=24, global_batch=6, seed=3,
                  path=path, n_replicas=3, replica_id=1)
        mine = Pipeline(DataConfig(**kw))
        theirs = ref_pipeline.Pipeline(ref_pipeline.DataConfig(**kw))
        for step in (0, 5, 11):
            a, b = mine.batch_at(step), theirs.batch_at(step)
            assert set(a) == set(b)
            for key in a:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


# ============================================================ checkpoint

def tree_of(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((3, 4), generator=g),
            "b": {"c": torch.ones((5,), dtype=torch.int32),
                  "d": torch.zeros((), dtype=torch.int32)},
            "e": {}}


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
        tree = tree_of()
        mgr.save(10, tree, meta={"loss": 1.5})
        got, step, meta = mgr.restore(tree)
        assert step == 10 and meta["loss"] == 1.5
        torch.testing.assert_close(got["a"], tree["a"], rtol=0, atol=0)
        assert got["b"]["c"].dtype == torch.int32 and got["e"] == {}

    def test_keep_k_gc(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
        tree = {"x": torch.zeros(3)}
        for s in (1, 2, 3, 4):
            mgr.save(s, tree)
        assert mgr.all_steps() == [3, 4]

    def test_async_write_commits(self, tmp_path):
        mgr = CheckpointManager(tmp_path, keep=3, async_write=True)
        mgr.save(1, {"x": torch.arange(5.0)})
        mgr.wait()
        assert mgr.latest_step() == 1

    def test_crash_leaves_no_partial_checkpoint(self, tmp_path):
        """Only COMMITTED checkpoints are visible (atomic rename)."""
        mgr = CheckpointManager(tmp_path, keep=3, async_write=False)
        mgr.save(1, {"x": torch.arange(5.0)})
        (tmp_path / "step_000000099").mkdir()
        assert mgr.all_steps() == [1]

    def test_restore_rejects_another_tree(self, tmp_path):
        mgr = CheckpointManager(tmp_path, async_write=False)
        mgr.save(1, {"x": torch.zeros(3)})
        with pytest.raises(ValueError, match="leaf 0"):
            mgr.restore({"x": torch.zeros(4)})
        with pytest.raises(ValueError, match="leaves"):
            mgr.restore({"x": torch.zeros(3), "y": torch.zeros(1)})

    def test_reference_restores_the_ports_checkpoint(self, tmp_path):
        CheckpointManager(tmp_path, async_write=False).save(
            7, tree_of(1), meta={"loss": 2.0})
        example = {"a": jnp.zeros((3, 4)),
                   "b": {"c": jnp.zeros((5,), jnp.int32),
                         "d": jnp.zeros((), jnp.int32)}, "e": {}}
        got, step, meta = RefCheckpoints(tmp_path).restore(example)
        assert step == 7 and meta == {"loss": 2.0}
        np.testing.assert_array_equal(got["a"], tree_of(1)["a"].numpy())
        assert got["b"]["d"].dtype == np.int32

    def test_port_restores_the_references_checkpoint(self, tmp_path):
        tree = {"a": jnp.arange(12.0).reshape(3, 4),
                "b": {"c": jnp.ones((5,), jnp.int32),
                      "d": jnp.zeros((), jnp.int32)}, "e": {}}
        RefCheckpoints(tmp_path, async_write=False).save(3, tree)
        got, step, _ = CheckpointManager(tmp_path).restore(tree_of())
        assert step == 3
        np.testing.assert_array_equal(got["a"].numpy(), np.asarray(tree["a"]))
        assert got["b"]["c"].dtype == torch.int32


# ========================================================= fault-tolerant

class TestTrainerFT:
    def _mk(self, tmp_path, arch=ARCH, **kw):
        cfg = small_cfg(arch)
        tc = rt.TrainerConfig(**{"total_steps": 8, "ckpt_every": 4,
                                 "ckpt_dir": str(tmp_path), "keep": 3,
                                 "log_every": 100, **kw})
        return rt.Trainer(cfg, data_cfg(cfg), tc, log=lambda *_: None,
                          device="cpu")

    @pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_370m"])
    def test_loss_decreases(self, tmp_path, arch):
        out = self._mk(tmp_path, arch).run()
        losses = [h["loss"] for h in out["history"]]
        assert losses[-1] < losses[0]

    @pytest.mark.parametrize("arch", ["granite_3_2b", "mamba2_370m"])
    def test_failure_injection_and_restart_is_exact(self, tmp_path, arch):
        """Crash at step 6, restart from the step-4 checkpoint: the final
        loss equals an uninterrupted run's (deterministic data and
        step)."""
        ref_out = self._mk(tmp_path / "ref", arch).run()
        t = self._mk(tmp_path / "ft", arch, fail_at_steps=(6,))
        with pytest.raises(rt.SimulatedFailure):
            t.run()
        t2 = self._mk(tmp_path / "ft", arch)
        out = t2.run(resume=True)
        assert t2.ckpt.latest_step() == 8
        assert [h["step"] for h in out["history"]] == [4, 5, 6, 7]
        np.testing.assert_allclose(out["final_loss"],
                                   ref_out["final_loss"], rtol=1e-6)

    def test_no_checkpoint_when_ckpt_every_is_0(self, tmp_path):
        t = self._mk(tmp_path, ckpt_every=0, total_steps=2)
        t.run()
        assert t.ckpt.all_steps() == []

    def test_straggler_detector_flags_outlier(self):
        det = rt.StragglerDetector(warmup=3)
        for i in range(10):
            det.observe(i, 0.10)
        assert det.observe(99, 1.0)
        assert det.flagged and det.flagged[-1][0] == 99

    def test_grad_compression_error_feedback(self):
        """int8+EF: the quantization error is carried, so the SUM of
        applied gradients converges to the true sum."""
        g = {"w": torch.tensor(np.random.default_rng(0)
                               .normal(size=(64,)).astype(np.float32))}
        err = {"w": torch.zeros(64)}
        applied = torch.zeros(64)
        for _ in range(50):
            g_hat, err = rt.compressed_grads(g, err)
            applied = applied + g_hat["w"]
        np.testing.assert_allclose(applied.numpy() / 50, g["w"].numpy(),
                                   atol=1e-2)

    def test_int8_round_trip_is_the_references(self):
        """Quantized values, scale and the error-feedback pair equal the
        reference's, ties included (both round half to even)."""
        rng = np.random.default_rng(4)
        g = (rng.normal(size=(257,)) * 3).astype(np.float32)
        g[:4] = [127.0, -63.5, 0.5, 1.5]           # ties at scale 1
        q, s = rt.int8_compress(torch.tensor(g))
        rq, rs = ref_rt.int8_compress(jnp.asarray(g))
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        assert float(s) == float(rs)
        e = (rng.normal(size=(257,)) * 0.1).astype(np.float32)
        (gh, ne) = rt.compressed_grads({"w": torch.tensor(g)},
                                       {"w": torch.tensor(e)})
        rgh, rne = ref_rt.compressed_grads({"w": jnp.asarray(g)},
                                           {"w": jnp.asarray(e)})
        np.testing.assert_allclose(gh["w"].numpy(), np.asarray(rgh["w"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ne["w"].numpy(), np.asarray(rne["w"]),
                                   rtol=1e-6, atol=1e-6)

    def test_compressed_training_still_learns(self, tmp_path):
        out = self._mk(tmp_path, grad_compression="int8_ef").run()
        losses = [h["loss"] for h in out["history"]]
        assert losses[-1] < losses[0]

    def test_compressed_training_restart_is_exact(self, tmp_path):
        """The error buffer is part of the checkpointed state."""
        ref_out = self._mk(tmp_path / "ref",
                           grad_compression="int8_ef").run()
        t = self._mk(tmp_path / "ft", grad_compression="int8_ef",
                     fail_at_steps=(5,))
        with pytest.raises(rt.SimulatedFailure):
            t.run()
        out = self._mk(tmp_path / "ft", grad_compression="int8_ef").run()
        np.testing.assert_allclose(out["final_loss"],
                                   ref_out["final_loss"], rtol=1e-6)
