"""The trainer's substrate in the port against the reference on the CPU,
mirroring ``tests/test_substrate.py``: the data pipeline (bit-equal
batches for text, audio and vision, and the memmap source), checkpoints
(atomic, ``keep_last``, asynchronous, bf16 bit for bit), fault tolerance
(the watchdog driven by a patched clock, not by sleeps) and gradient
compression (bit-equal to the reference's ``bf16`` and ``int8`` codecs,
the error buffer included), and the in-place optimizer on the reference's
quadratic."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import MemmapDataset as RefMemmap
from repro.data.pipeline import SyntheticDataset as RefSynthetic
from repro.runtime.compression import compress_grads as ref_compress
from repro.runtime.compression import decompress_grads as ref_decompress
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.data import (DataConfig, MemmapDataset, SyntheticDataset,
                              make_dataset)
from repro_torch.optim.adamw import OptimizerConfig, adamw_init, adamw_update_
from repro_torch.runtime import (PreemptionHandler, StepWatchdog,
                                 compress_grads, decompress_grads)
from repro_torch.runtime import fault_tolerance as FT

# one arch of each batch layout: text, audio (features, labels, mask),
# vision (patches before the text)
DATA_ARCHS = ["stablelm-3b", "hubert-xlarge", "internvl2-2b"]


class TestData:
    @pytest.mark.parametrize("arch", DATA_ARCHS)
    @pytest.mark.parametrize("seq_len, step, shard", [(16, 0, 0), (64, 42, 1)])
    def test_synthetic_bit_equal_to_reference(self, arch, seq_len, step, shard):
        kw = dict(seq_len=seq_len, batch_size=3, seed=7, n_shards=2,
                  shard=shard)
        want = RefSynthetic(ref_reduced(REF_ARCHS[arch]),
                            RefDataConfig(**kw)).get_batch(step)
        got = SyntheticDataset(reduced_config(ARCHS[arch]),
                               DataConfig(**kw)).get_batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])

    def test_synthetic_deterministic_by_step(self):
        cfg = reduced_config(ARCHS["stablelm-3b"])
        d = SyntheticDataset(cfg, DataConfig(seq_len=16, batch_size=4, seed=7))
        np.testing.assert_array_equal(d.get_batch(42)["tokens"],
                                      d.get_batch(42)["tokens"])
        assert not np.array_equal(d.get_batch(42)["tokens"],
                                  d.get_batch(43)["tokens"])

    def test_shards_disjoint_streams(self):
        cfg = reduced_config(ARCHS["stablelm-3b"])

        def mk(s):
            return SyntheticDataset(cfg, DataConfig(
                seq_len=16, batch_size=4, seed=7, n_shards=2, shard=s))
        assert not np.array_equal(mk(0).get_batch(5)["tokens"],
                                  mk(1).get_batch(5)["tokens"])

    def test_labels_are_next_tokens(self):
        cfg = reduced_config(ARCHS["stablelm-3b"])
        b = SyntheticDataset(cfg, DataConfig(seq_len=16,
                                             batch_size=2)).get_batch(0)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_memmap_bit_equal_to_reference(self, tmp_path):
        path = str(tmp_path / "tokens.bin")
        np.arange(10_000, dtype=np.uint16).tofile(path)
        kw = dict(seq_len=32, batch_size=4, seed=2, shard=1)
        cfg = reduced_config(ARCHS["stablelm-3b"])
        d = make_dataset(cfg, DataConfig(**kw), path)
        assert isinstance(d, MemmapDataset)
        want = RefMemmap(ref_reduced(REF_ARCHS["stablelm-3b"]),
                         RefDataConfig(**kw), path).get_batch(3)
        got = d.get_batch(3)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])
        assert isinstance(make_dataset(cfg, DataConfig(**kw),
                                       str(tmp_path / "missing.bin")),
                          SyntheticDataset)

    def test_memmap_too_short(self, tmp_path):
        path = str(tmp_path / "short.bin")
        np.arange(8, dtype=np.uint16).tofile(path)
        with pytest.raises(ValueError, match="shorter than one sequence"):
            MemmapDataset(reduced_config(ARCHS["stablelm-3b"]),
                          DataConfig(seq_len=32, batch_size=1), path)


class TestCheckpoint:
    def _tree(self, v=0.0):
        return {"a": torch.full((4, 4), v),
                "b": {"x": torch.arange(3.0),
                      "n": torch.tensor(7, dtype=torch.int32)},
                "h": torch.full((5,), v).to(torch.bfloat16)}

    def test_roundtrip_and_manifest(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        tree = self._tree(1.5)
        mgr.save(10, tree)
        restored, step = mgr.restore(self._tree())
        assert step == 10
        for k in ("a", "h"):
            assert restored[k].dtype == tree[k].dtype
            assert torch.equal(restored[k], tree[k])
        assert torch.equal(restored["b"]["x"], tree["b"]["x"])
        assert restored["b"]["n"].dtype == torch.int32
        with open(tmp_path / "step_00000010" / "manifest.json") as f:
            manifest = json.load(f)
        assert manifest["step"] == 10 and manifest["n_leaves"] == 4
        assert [(leaf["name"], leaf["dtype"], leaf["shape"])
                for leaf in manifest["leaves"]] == [
            ("a", "float32", [4, 4]), ("b/x", "float32", [3]),
            ("b/n", "int32", []), ("h", "bfloat16", [5])]
        assert np.load(tmp_path / "step_00000010" / "arr_3.npy").dtype \
            == np.uint16

    def test_bf16_bit_exact(self, tmp_path):
        """Every bf16 bit pattern but the NaNs comes back as it was."""
        bits = torch.arange(-2**15, 2**15, dtype=torch.int32).to(torch.int16)
        t = bits.view(torch.bfloat16)
        finite = ~torch.isnan(t)
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"t": t})
        got, _ = mgr.restore({"t": torch.zeros_like(t)})
        assert torch.equal(got["t"].view(torch.int16)[finite], bits[finite])
        assert bool(torch.isnan(got["t"][~finite]).all())

    def test_restore_takes_like_dtype_and_device(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(3, {"w": torch.linspace(-1, 1, 6)})
        like = {"w": torch.zeros(6, dtype=torch.float64)}
        got, _ = mgr.restore(like)
        assert got["w"].dtype == torch.float64
        torch.testing.assert_close(got["w"].float(), torch.linspace(-1, 1, 6))
        got, _ = mgr.restore(like, device="meta")
        assert got["w"].device.type == "meta"
        with pytest.raises(KeyError, match="no leaf"):
            mgr.restore({"v": torch.zeros(6)})
        with pytest.raises(ValueError, match="shape"):
            mgr.restore({"w": torch.zeros(7)})

    def test_latest_and_cleanup(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self._tree(float(s)))
        assert mgr.all_steps() == [3, 4]
        restored, step = mgr.restore(self._tree())
        assert step == 4 and float(restored["a"][0, 0]) == 4.0
        restored, step = mgr.restore(self._tree(), step=3)
        assert step == 3 and float(restored["a"][0, 0]) == 3.0

    def test_async_save_copies_before_returning(self, tmp_path):
        """The loop may write into its tensors as soon as ``save`` returns:
        the checkpoint holds the values at the call."""
        mgr = CheckpointManager(str(tmp_path))
        tree = self._tree(2.0)
        mgr.save(5, tree, blocking=False)
        tree["a"].add_(100.0)
        tree["h"].zero_()
        mgr.wait()
        restored, step = mgr.restore(self._tree())
        assert step == 5
        assert float(restored["a"].max()) == 2.0
        assert float(restored["h"].min()) == 2.0

    def test_atomicity_no_partial_dirs(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self._tree())
        os.makedirs(tmp_path / "step_00000009.tmp")   # a crashed save
        os.makedirs(tmp_path / "step_00000008")        # no manifest yet
        assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
        mgr.save(9, self._tree(9.0))
        assert not os.path.exists(tmp_path / "step_00000009.tmp")
        assert mgr.latest_step() == 9

    def test_empty_directory(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path / "new"))
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore(self._tree())


class _Clock:
    """A stand-in for ``time.monotonic`` that a test advances."""

    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


class TestFaultTolerance:
    def test_preemption_flag(self):
        h = PreemptionHandler()
        assert not h.should_stop
        h.trigger()
        assert h.should_stop
        h2 = PreemptionHandler()
        h2._handler(15, None)                  # what SIGTERM calls
        assert h2.should_stop

    def test_watchdog_flags_stragglers(self, monkeypatch):
        clock = _Clock()
        monkeypatch.setattr(FT.time, "monotonic", clock)
        events = []
        wd = StepWatchdog(factor=5.0, warmup=3,
                          on_straggler=lambda s, dt, med: events.append(s))
        for step in range(10):
            wd.start_step(step)
            clock.now += 0.120 if step == 7 else 0.002
            assert wd.end_step() == pytest.approx(0.120 if step == 7
                                                  else 0.002)
        assert wd.straggler_steps == [7] and events == [7]
        assert wd.median_step_time == pytest.approx(0.002)

    def test_watchdog_warmup_and_window(self, monkeypatch):
        clock = _Clock()
        monkeypatch.setattr(FT.time, "monotonic", clock)
        wd = StepWatchdog(factor=2.0, window=3, warmup=2)
        for step, dt in enumerate([1.0, 5.0, 1.0, 1.0, 1.0, 1.0, 2.5]):
            wd.start_step(step)
            clock.now += dt
            wd.end_step()
        # step 1 is within the warmup; step 6 is over twice the median of
        # the last three (1.0)
        assert wd.straggler_steps == [6]
        with pytest.raises(RuntimeError):
            StepWatchdog().end_step()


class TestCompression:
    def _grads(self):
        rng = np.random.default_rng(0)
        return {"w": (rng.standard_normal((64, 64)) * 0.01).astype(np.float32),
                "b": rng.standard_normal(64).astype(np.float32),
                "z": np.zeros((3, 5), np.float32)}

    def test_bf16_bit_equal_to_reference(self):
        g = self._grads()
        want_wire, _ = ref_compress({k: jnp.asarray(v) for k, v in g.items()},
                                    "bf16")
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        wire, err = compress_grads(tg, "bf16")
        assert err is None
        for k in g:
            assert wire[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                wire[k].view(torch.int16).numpy(),
                np.asarray(want_wire[k]).view(np.int16))
        back = decompress_grads(wire, "bf16", tg)
        assert back["w"].dtype == torch.float32
        np.testing.assert_allclose(back["w"], g["w"], rtol=1e-2, atol=1e-4)

    @pytest.mark.parametrize("with_error", [False, True])
    def test_int8_bit_equal_to_reference(self, with_error):
        g = self._grads()
        rng = np.random.default_rng(1)
        e = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in g.items()} if with_error else None
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        want_wire, want_err = ref_compress(
            jg, "int8", None if e is None else
            {k: jnp.asarray(v) for k, v in e.items()})
        want_back = ref_decompress(want_wire, "int8", jg)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        wire, err = compress_grads(tg, "int8", None if e is None else
                                   {k: torch.from_numpy(v)
                                    for k, v in e.items()})
        back = decompress_grads(wire, "int8", tg)
        for k in g:
            qg, scale = wire[k]
            assert qg.dtype == torch.int8 and scale.dtype == torch.float32
            np.testing.assert_array_equal(qg.numpy(),
                                          np.asarray(want_wire[k][0]))
            assert float(scale) == float(want_wire[k][1])
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(want_err[k]))
            np.testing.assert_array_equal(back[k].numpy(),
                                          np.asarray(want_back[k]))

    def test_int8_error_feedback(self):
        g = {k: torch.from_numpy(v) for k, v in self._grads().items()}
        wire, err = compress_grads(g, "int8")
        back = decompress_grads(wire, "int8", g)
        scale = float(wire["w"][1])
        assert float((back["w"] - g["w"]).abs().max()) <= scale / 2 + 1e-7
        # the residual is exactly what quantization lost
        torch.testing.assert_close(g["w"] - back["w"], err["w"], rtol=0,
                                   atol=1e-7)
        assert torch.equal(back["z"], g["z"])   # a zero leaf stays zero

    def test_none_and_unknown(self):
        g = {"w": torch.ones(3)}
        assert compress_grads(g, "none") == (g, None)
        assert decompress_grads(g, None, g) is g
        with pytest.raises(ValueError, match="unknown compression"):
            compress_grads(g, "fp4")
        with pytest.raises(ValueError, match="unknown compression"):
            decompress_grads(g, "fp4", g)


class TestInPlaceOptimizer:
    def test_converges_on_quadratic(self):
        cfg = OptimizerConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                              total_steps=200, min_lr_ratio=1.0)
        target = torch.tensor([[1.5, -2.0], [0.5, 3.0]])
        params = {"w": torch.zeros((2, 2))}
        w = params["w"]
        state = adamw_init(params, cfg)
        for _ in range(200):
            adamw_update_({"w": params["w"] - target}, state, params, cfg)
        assert params["w"] is w                 # written in place
        torch.testing.assert_close(params["w"], target, atol=0.05, rtol=0)

    def test_clipping_bounds_update(self):
        cfg = OptimizerConfig(lr=1.0, clip_norm=1e-3, weight_decay=0.0,
                              warmup_steps=0)
        params = {"w": torch.zeros(4)}
        state = adamw_init(params, cfg)
        m, step = adamw_update_({"w": torch.full((4,), 1e9)}, state, params,
                                cfg)
        assert float(m["grad_norm"]) > 1e8 and int(step) == 1
        assert float(params["w"].abs().max()) < 10.0

    def test_decayed_names(self):
        """``decayed`` picks the leaves that take weight decay."""
        cfg = OptimizerConfig(lr=0.1, weight_decay=0.5, warmup_steps=0)
        params = {"v": torch.ones(4), "m": torch.ones((2, 2))}
        zero = {"v": torch.zeros(4), "m": torch.zeros((2, 2))}
        adamw_update_(dict(zero), adamw_init(params, cfg), params, cfg,
                      decayed={"v"})
        assert float(params["v"][0]) < 1.0 and float(params["m"][0, 0]) == 1.0
