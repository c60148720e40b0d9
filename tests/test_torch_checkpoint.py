# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the checkpoint engine (``models/checkpoint.py``): the
reference's ``tests/test_checkpoint.py`` cases against the port's module
— round trips, retention, async flush/close/clear, truncation, bit flips,
a crash mid-write, a missing manifest, a stale config, strict steps,
quarantine evidence, bf16 bits, ``stored_world``, the no-split-brain
restore — with gloo worlds (``_torch_world.py``) where the reference
shards over ``jax8``: a train state written by a world of 4 (dp 2 × tp 2,
ZeRO-1 moments) restores into worlds of 2 and 1 and back, a row-sharded
leaf restores misaligned (4 → 3 ranks), across axes (rows → columns) and
grown (1 → 4), and AdamW resumes bit for bit in a world of 4. Interop:
a step the JAX package's ``Checkpointer`` writes restores in the port bit
for bit, and the reverse, at f32 and bf16, with the same leaf paths.

The remote backend (``memory://`` and ``file://`` through ``fsspec``; no
test builds a ``gs://`` filesystem): round trips, the manifest as the
commit point (a crash before it leaves no visible step, and the sweep's
age gate), quarantine of truncated and flipped steps, retention, clear,
async saves, the layout byte for byte (a step copied to a local
directory restores in both packages' local ``Checkpointer``), a missing
protocol, and a world of 2 on a shared ``file://`` directory.

Every comparison here is exact (bytes in, bytes out).
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_world import run_world

from nvidia_terraform_modules_tpu.models import burnin as jburnin
from nvidia_terraform_modules_tpu.models import checkpoint as jckpt
from nvidia_terraform_modules_tpu.models import optimizer as jopt
from nvidia_terraform_modules_tpu_torch.models import (
    AdamWConfig,
    BurnInConfig,
    CheckpointError,
    Checkpointer,
    CorruptCheckpointError,
    MissingStepError,
    abstract_train_state,
    clear_checkpoints,
    init_params,
    latest_step,
    make_adamw_train_step,
    make_train_step,
    params_from_numpy,
    params_to_numpy,
    restore_checkpoint,
    save_checkpoint,
    synthetic_batch,
    tree_leaves,
)
from nvidia_terraform_modules_tpu_torch.models import checkpoint as ckpt_mod
from nvidia_terraform_modules_tpu_torch.models.burnin import _tree_map
from nvidia_terraform_modules_tpu_torch.parallel import ShapeDtypeStruct

CPU = torch.device("cpu")


def _tiny_cfg(dtype=torch.float32, **over):
    kw = dict(vocab=32, d_model=16, n_heads=2, d_ff=32, n_layers=1,
              seq_len=8, batch=2)
    return BurnInConfig(**{**kw, **over}, dtype=dtype)


def _params(cfg, seed=0):
    return init_params(cfg, torch.Generator().manual_seed(seed),
                       device="cpu")


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _restore(d, cfg, step=None):
    with Checkpointer(str(d)) as c:
        return c.restore(cfg, step=step, device="cpu")


def _save_steps(d, cfg, steps, max_to_keep=8):
    trees = {}
    with Checkpointer(str(d), max_to_keep=max_to_keep) as c:
        for s in steps:
            params = _tree_map(lambda x: x + float(s), _params(cfg))
            c.save(s, params, meta={"step": s})
            trees[s] = params
    return trees


def _shard_files(d, step):
    return sorted((d / f"step_{step:08d}").glob("shards_p*.bin"))


# ------------------------------------------------------- one process

def test_roundtrip_unsharded(tmp_path):
    cfg = _tiny_cfg()
    params = _params(cfg)
    save_checkpoint(str(tmp_path), 3, params, meta={"last_loss": 1.25})
    assert latest_step(str(tmp_path)) == 3
    restored, step, meta = restore_checkpoint(str(tmp_path), cfg,
                                              device="cpu")
    assert step == 3 and meta == {"last_loss": 1.25}
    assert _leaves_equal(params, restored)


def test_retention_keeps_latest(tmp_path):
    params = _params(_tiny_cfg())
    for s in (1, 2, 3):
        save_checkpoint(str(tmp_path), s, params, max_to_keep=2)
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(MissingStepError):
        _restore(tmp_path, _tiny_cfg(), step=1)


def test_missing_dir_is_fresh_start(tmp_path):
    assert latest_step(str(tmp_path / "nope")) is None
    assert restore_checkpoint(str(tmp_path / "nope"), _tiny_cfg(),
                              device="cpu") is None
    assert not (tmp_path / "nope").exists()


def test_resume_matches_uninterrupted_run(tmp_path):
    """Preemption is invisible: 5 steps + save + restore + 5 == 10."""
    cfg = _tiny_cfg(n_layers=2)
    step = make_train_step(cfg, lr=0.05, device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    ref = _params(cfg)
    for _ in range(10):
        ref, _ = step(ref, batch)
    params = _params(cfg)
    for _ in range(5):
        params, _ = step(params, batch)
    save_checkpoint(str(tmp_path), 5, params)
    del params
    resumed, at, _ = restore_checkpoint(str(tmp_path), cfg, device="cpu")
    assert at == 5
    for _ in range(5):
        resumed, _ = step(resumed, batch)
    assert _leaves_equal(ref, resumed)


def test_adamw_train_state_resume_bit_exact_world_of_one(tmp_path):
    cfg = _tiny_cfg(n_heads=4, n_layers=1, seq_len=16, batch=8, vocab=64,
                    d_model=32, d_ff=64)
    init_state, step = make_adamw_train_step(cfg, opt=AdamWConfig(lr=1e-2),
                                             device="cpu")
    batch = synthetic_batch(torch.Generator().manual_seed(1), cfg,
                            device="cpu")
    params = _params(cfg)
    state = init_state(params)
    for _ in range(6):
        params, state, _ = step(params, state, batch)
    p2 = _params(cfg)
    s2 = init_state(p2)
    for _ in range(3):
        p2, s2, _ = step(p2, s2, batch)
    with Checkpointer(str(tmp_path / "ckpt")) as c:
        c.save(3, {"params": p2, "opt": s2}, meta={"phase": "burnin"})
    del p2, s2
    with Checkpointer(str(tmp_path / "ckpt")) as c:
        tree, at_step, meta = c.restore_tree(
            abstract_train_state(cfg, device="cpu"))
    assert at_step == 3 and meta == {"phase": "burnin"}
    p2, s2 = tree["params"], tree["opt"]
    assert s2["step"].dtype == torch.int32 and int(s2["step"]) == 3
    for _ in range(3):
        p2, s2, _ = step(p2, s2, batch)
    assert _leaves_equal(params, p2)
    assert _leaves_equal([state["mu"], state["nu"]], [s2["mu"], s2["nu"]])
    assert torch.equal(state["step"], s2["step"])


def test_clear_checkpoints(tmp_path):
    params = _params(_tiny_cfg())
    for s in (1, 2):
        save_checkpoint(str(tmp_path), s, params)
    assert clear_checkpoints(str(tmp_path)) == 2
    assert latest_step(str(tmp_path)) is None
    assert clear_checkpoints(str(tmp_path / "nope")) == 0


def _no_gcsfs(monkeypatch):
    """``gs://`` as on a machine without ``gcsfs``: fsspec's import error
    for the protocol (no test builds a real ``gs://`` filesystem)."""
    import fsspec.core

    real = fsspec.core.url_to_fs

    def url_to_fs(url, **kw):
        if url.startswith("gs://"):
            raise ImportError("Install gcsfs to access Google Storage")
        return real(url, **kw)

    monkeypatch.setattr(fsspec.core, "url_to_fs", url_to_fs)


def test_remote_paths_never_touch_local_fs(tmp_path, monkeypatch):
    """A gs:// URI is not mangled into <cwd>/gs:/…; the constructor
    touches no storage (its filesystem is resolved at the first read or
    write), and where the protocol's package is missing a save raises
    :class:`CheckpointError` naming the protocol — it never falls back to
    a local directory."""
    monkeypatch.chdir(tmp_path)
    _no_gcsfs(monkeypatch)
    assert ckpt_mod._root("gs://bucket/ckpt") == "gs://bucket/ckpt"
    assert not ckpt_mod._no_checkpoint_possible("gs://bucket/ckpt")
    assert ckpt_mod._root("rel/path").startswith("/")
    ck = Checkpointer("gs://bucket/ckpt")
    assert ck._store._fs is None
    with pytest.raises(CheckpointError, match="gs:// protocol"):
        save_checkpoint("gs://bucket/ckpt", 1, _params(_tiny_cfg()))
    with pytest.raises(CheckpointError, match="gs:// protocol"):
        ck.latest_step()
    assert os.listdir(tmp_path) == []


def test_async_save_roundtrips_and_flushes(tmp_path):
    cfg = _tiny_cfg()
    params = _params(cfg)
    d = str(tmp_path / "ck")
    with Checkpointer(d, async_save=True) as ck:
        ck.save(1, params, meta={"tag": "a"})
        bumped = {**params, "embed": params["embed"] + 1.0}
        ck.save(2, bumped, meta={"tag": "b"})
        ck.flush()
        assert ck.latest_step() == 2
        assert ck.last_commit["bytes"] == sum(
            t.numel() * t.element_size() for t in tree_leaves(bumped))
    restored, step, meta = _restore(d, cfg)
    assert step == 2 and meta["tag"] == "b"
    assert _leaves_equal(bumped, restored)


def test_async_snapshot_is_taken_at_save(tmp_path):
    """An async save copies the tensors before it returns: writing them
    afterwards does not reach the committed step."""
    cfg = _tiny_cfg()
    params = _params(cfg)
    want = params["embed"].clone()
    with Checkpointer(str(tmp_path), async_save=True) as ck:
        ck.save(1, params)
        params["embed"].add_(5.0)
    restored, _, _ = _restore(tmp_path, cfg)
    assert torch.equal(restored["embed"], want)


def test_async_close_commits_pending_save(tmp_path):
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, async_save=True)
    ck.save(7, _params(_tiny_cfg()))
    ck.close()
    assert latest_step(d) == 7


def test_async_clear_commits_then_removes_everything(tmp_path):
    params = _params(_tiny_cfg())
    d = str(tmp_path / "ck")
    with Checkpointer(d, async_save=True) as ck:
        ck.save(1, params)
        ck.save(2, params)
        assert ck.clear() == 2
    assert latest_step(d) is None


def test_truncated_checkpoint_falls_back_to_prior_step(tmp_path):
    cfg = _tiny_cfg()
    trees = _save_steps(tmp_path, cfg, (1, 2, 3))
    f = _shard_files(tmp_path, 3)[0]
    f.write_bytes(f.read_bytes()[:10])
    with Checkpointer(str(tmp_path)) as c:
        restored, step, meta = c.restore(cfg, device="cpu")
        assert step == 2 and meta == {"step": 2}
        assert _leaves_equal(trees[2], restored)
        assert c.latest_step() == 2
        assert any(q.startswith("step_00000003") for q in c.quarantined())
        again, step2, _ = c.restore(cfg, device="cpu")
        assert step2 == 2 and _leaves_equal(restored, again)


def test_bitflip_checksum_fallback(tmp_path):
    cfg = _tiny_cfg()
    trees = _save_steps(tmp_path, cfg, (1, 2))
    f = _shard_files(tmp_path, 2)[0]
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    restored, step, _ = _restore(tmp_path, cfg)
    assert step == 1 and _leaves_equal(trees[1], restored)


def test_crash_mid_write_is_invisible(tmp_path):
    cfg = _tiny_cfg()
    trees = _save_steps(tmp_path, cfg, (1,))
    fake = tmp_path / ".tmp.step_00000002"
    fake.mkdir()
    (fake / "shards_p00000.bin").write_bytes(b"half-written")
    with Checkpointer(str(tmp_path)) as c:
        assert c.latest_step() == 1
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 1 and _leaves_equal(trees[1], restored)


def test_missing_manifest_never_lists(tmp_path):
    _save_steps(tmp_path, _tiny_cfg(), (1,))
    bogus = tmp_path / "step_00000009"
    bogus.mkdir()
    (bogus / "shards_p00000.bin").write_bytes(b"junk")
    with Checkpointer(str(tmp_path)) as c:
        assert c.latest_step() == 1
        assert c.all_steps() == [1]


def test_stale_config_checkpoint_quarantined(tmp_path):
    _save_steps(tmp_path, _tiny_cfg(), (1,))
    other = _tiny_cfg(vocab=16, d_model=8, d_ff=16)
    with Checkpointer(str(tmp_path)) as c:
        assert c.restore(other, device="cpu") is None
        assert c.quarantined()
        assert c.latest_step() is None


def test_stale_dtype_checkpoint_quarantined(tmp_path):
    """Same shapes, another dtype (f32 on disk, a bf16 run): stale."""
    _save_steps(tmp_path, _tiny_cfg(), (1,))
    with Checkpointer(str(tmp_path)) as c:
        assert c.restore(_tiny_cfg(torch.bfloat16), device="cpu") is None
        assert any("stale" in q for q in c.quarantined())


def test_explicit_step_is_strict(tmp_path):
    cfg = _tiny_cfg()
    _save_steps(tmp_path, cfg, (1, 2))
    _shard_files(tmp_path, 2)[0].write_bytes(b"")
    with Checkpointer(str(tmp_path)) as c:
        with pytest.raises(CorruptCheckpointError):
            c.restore(cfg, step=2, device="cpu")
        with pytest.raises(CheckpointError):
            c.restore(cfg, step=7, device="cpu")


def test_quarantine_preserves_evidence_and_clear_keeps_it(tmp_path):
    cfg = _tiny_cfg()
    _save_steps(tmp_path, cfg, (1, 2))
    f = _shard_files(tmp_path, 2)[0]
    f.write_bytes(f.read_bytes()[:4])
    with Checkpointer(str(tmp_path)) as c:
        _, step, _ = c.restore(cfg, device="cpu")
        assert step == 1
        assert c.clear() == 1
        assert c.latest_step() is None
        assert c.quarantined()
    (evidence,) = (tmp_path / "quarantine").iterdir()
    assert (evidence / "manifest.json").is_file()
    assert len((evidence / "shards_p00000.bin").read_bytes()) == 4


def test_bf16_roundtrip_bit_exact(tmp_path):
    cfg = _tiny_cfg(torch.bfloat16)
    params = _params(cfg, seed=3)
    with Checkpointer(str(tmp_path)) as c:
        c.save(1, params)
        restored, _, _ = c.restore(cfg, device="cpu")
    manifest = json.loads((tmp_path / "step_00000001" /
                           "manifest.json").read_text())
    assert {r["dtype"] for r in manifest["leaves"]} == {"bfloat16"}
    for a, b in zip(tree_leaves(params), tree_leaves(restored)):
        assert b.dtype == torch.bfloat16
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def test_async_save_failure_surfaces_at_flush(tmp_path):
    params = _params(_tiny_cfg())
    target = tmp_path / "ck"
    ck = Checkpointer(str(target), async_save=True)
    ck.save(1, params)
    ck.flush()
    shutil.rmtree(target)
    target.write_text("not a directory")
    try:
        ck.save(2, params)
        with pytest.raises(CheckpointError):
            ck.flush()
    finally:
        target.unlink()
        ck.close()


def test_stored_world_reports_writer_process_count(tmp_path):
    _save_steps(tmp_path, _tiny_cfg(), (4,))
    with Checkpointer(str(tmp_path)) as c:
        assert c.stored_world(4) == 1
        assert c.stored_world(9) is None


def test_unreadable_shard_range_classifies_and_falls_back(tmp_path):
    cfg = _tiny_cfg()
    trees = _save_steps(tmp_path, cfg, (1, 2))
    f = _shard_files(tmp_path, 2)[0]
    f.unlink()
    f.mkdir()
    with Checkpointer(str(tmp_path)) as c:
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 1 and _leaves_equal(trees[1], restored)
        assert any(q.startswith("step_00000002") for q in c.quarantined())


def test_multihost_restore_verifies_all_records_no_split_brain(
        tmp_path, monkeypatch):
    """A corrupt duplicate record that dedup never reads: a world of one
    restores the step; "rank 0 of 2" verifies every record first,
    quarantines it and falls back — the verdict every peer reaches."""
    cfg = _tiny_cfg()
    trees = _save_steps(tmp_path, cfg, (1, 2))
    mpath = tmp_path / "step_00000002" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    dup = dict(manifest["leaves"][0])
    dup["crc32"] = (dup["crc32"] ^ 0xFFFFFFFF) & 0xFFFFFFFF
    manifest["leaves"].append(dup)
    mpath.write_text(json.dumps(manifest))
    with Checkpointer(str(tmp_path)) as c:
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 2 and _leaves_equal(trees[2], restored)
        assert not c.quarantined()
    monkeypatch.setattr(ckpt_mod, "_world", lambda: (0, 2))
    with Checkpointer(str(tmp_path)) as c:
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 1 and _leaves_equal(trees[1], restored)
        assert any(q.startswith("step_00000002") for q in c.quarantined())


def test_save_without_a_layout_in_a_larger_world_raises(tmp_path,
                                                        monkeypatch):
    """A tensor alone does not say which piece of its leaf a rank holds:
    in a world above one a save needs the layout (or a restore first)."""
    monkeypatch.setattr(ckpt_mod, "_world", lambda: (0, 2))
    with pytest.raises(CheckpointError, match="layout"):
        Checkpointer(str(tmp_path)).save(1, _params(_tiny_cfg()))


def test_placement_must_match_the_tensor(tmp_path):
    layout = {"w": ShapeDtypeStruct((4, 4), torch.float32, CPU)}
    with pytest.raises(CheckpointError, match="placement says"):
        Checkpointer(str(tmp_path)).save(1, {"w": torch.zeros(2, 4)},
                                         layout=layout)


# ------------------------------------------------------- interop

INTEROP = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=2,
               seq_len=16, batch=8)


def _jax_state(jdtype, rules=None):
    jcfg = jburnin.BurnInConfig(**INTEROP, dtype=jdtype)
    init_state, step = jopt.make_adamw_train_step(
        jcfg, rules, jopt.AdamWConfig(lr=1e-2))
    params = jburnin.init_params(jax.random.PRNGKey(5), jcfg, rules)
    state = init_state(params)
    batch = jburnin.synthetic_batch(jax.random.PRNGKey(6), jcfg, rules)
    params, state, _ = step(params, state, batch)   # non-zero moments
    return jcfg, {"params": params, "opt": state}


def _np_bits(x):
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _torch_bits(t):
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "dp2xtp4"])
def test_jax_checkpoint_restores_in_port_bitwise(tmp_path, jax8, dtype,
                                                 sharded):
    """The JAX package's Checkpointer writes an AdamW train state (on a dp
    2 × tp 4 mesh: a record for each distinct piece); the port restores
    it through ``abstract_train_state`` with the same paths and bits."""
    rules = None
    if sharded:
        from nvidia_terraform_modules_tpu.parallel import (
            build_mesh as jbuild,
        )
        from nvidia_terraform_modules_tpu.parallel import (
            make_rules as jrules,
        )
        from nvidia_terraform_modules_tpu.parallel import plan_mesh as jplan

        rules = jrules(jbuild(jplan(8, tp=4)))
    _, state = _jax_state(getattr(jnp, dtype), rules)
    with jckpt.Checkpointer(str(tmp_path)) as c:
        c.save(4, state, meta={"from": "jax"})
    cfg = BurnInConfig(**INTEROP, dtype=getattr(torch, dtype))
    with Checkpointer(str(tmp_path)) as c:
        tree, step, meta = c.restore_tree(abstract_train_state(
            cfg, device="cpu"))
    assert step == 4 and meta == {"from": "jax"}
    want = jax.tree_util.tree_leaves_with_path(state)
    got = dict(ckpt_mod._flatten(tree))
    assert sorted(got) == sorted(jax.tree_util.keystr(p) for p, _ in want)
    for path, w in want:
        g = got[jax.tree_util.keystr(path)]
        np.testing.assert_array_equal(_torch_bits(g), _np_bits(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax_bitwise(tmp_path, jax8, dtype):
    """The reverse: the port's train state (an AdamW step taken, bf16
    bytes through int16 views) restores in the JAX package's Checkpointer
    through its ``abstract_train_state``, bit for bit."""
    cfg = BurnInConfig(**INTEROP, dtype=getattr(torch, dtype))
    init_state, step = make_adamw_train_step(cfg, opt=AdamWConfig(lr=1e-2),
                                             device="cpu")
    params = _params(cfg, seed=4)
    state = init_state(params)
    batch = synthetic_batch(torch.Generator().manual_seed(2), cfg,
                            device="cpu")
    params, state, _ = step(params, state, batch)
    with Checkpointer(str(tmp_path)) as c:
        c.save(9, {"params": params, "opt": state}, meta={"from": "port"})
    jcfg = jburnin.BurnInConfig(**INTEROP, dtype=getattr(jnp, dtype))
    with jckpt.Checkpointer(str(tmp_path)) as c:
        tree, at, meta = c.restore_tree(jopt.abstract_train_state(jcfg))
    assert at == 9 and meta == {"from": "port"}
    got = dict(ckpt_mod._flatten({"params": params, "opt": state}))
    for path, w in jax.tree_util.tree_leaves_with_path(tree):
        g = got[jax.tree_util.keystr(path)]
        assert np.dtype(w.dtype).name == ckpt_mod._DTYPE_NAMES[g.dtype]
        np.testing.assert_array_equal(_np_bits(w), _torch_bits(g))


def test_leaf_paths_are_keystr(jax8):
    """The port names every leaf as ``jax.tree_util.keystr`` does, in
    the same order: a one-character difference would make every record
    "missing" on the other side."""
    jcfg, state = _jax_state(jnp.float32)
    cfg = BurnInConfig(**INTEROP, dtype=torch.float32)
    ported = {"params": params_from_numpy(
        jax.tree.map(np.asarray, state["params"]), cfg, device="cpu"),
        "opt": {"step": torch.tensor(1, dtype=torch.int32),
                "mu": params_from_numpy(jax.tree.map(
                    np.asarray, state["opt"]["mu"]), cfg, device="cpu"),
                "nu": params_from_numpy(jax.tree.map(
                    np.asarray, state["opt"]["nu"]), cfg, device="cpu")}}
    assert [p for p, _ in ckpt_mod._flatten(ported)] == [
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_leaves_with_path(state)]
    assert ckpt_mod._flatten({"a": [{"b": 1}, 2], "c": (3,)}) == [
        ("['a'][0]['b']", 1), ("['a'][1]", 2), ("['c'][0]", 3)]


# ------------------------------------------------------- gloo worlds

STATE_CFG = dict(vocab=64, d_model=32, n_heads=4, d_ff=64, n_layers=1,
                 seq_len=16, batch=8)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax8):
    """One run of each world; every directory, and each rank's results."""
    root = tmp_path_factory.mktemp("ckworlds")
    jcfg = jburnin.BurnInConfig(**STATE_CFG, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jburnin.init_params(
        jax.random.PRNGKey(2), jcfg))
    stream = np.random.default_rng(3).integers(
        0, STATE_CFG["vocab"], size=(8, 17), dtype=np.int32)
    w = np.arange(96.0, dtype=np.float32).reshape(24, 4)
    d = {k: str(root / k) for k in ("one", "four", "rows", "rows_bad",
                                    "adamw", "two", "two_remote")}
    # a world of one writes (in this process: no process group)
    cfg = BurnInConfig(**STATE_CFG, dtype=torch.float32)
    full = params_from_numpy(params, cfg, device="cpu")
    with Checkpointer(d["one"]) as c:
        mu = _tree_map(lambda p: p.float() * 2 + 1, full)
        c.save(7, {"params": full, "opt": {
            "step": torch.tensor(7, dtype=torch.int32), "mu": mu,
            "nu": mu}}, meta={"world": 1})
    with Checkpointer(d["rows"]) as c:
        c.save(1, {"w": torch.from_numpy(w) + 1})
    common = {"cfg": STATE_CFG, "params": params, "w": w,
              "batch": (stream[:, :-1], stream[:, 1:])}
    four = run_world("checkpoint_ops", 4, root / "w4", {**common, "ops": [
        {"op": "restore_state", "dir": d["one"], "tp": 2},     # 1 → 4
        {"op": "save_state", "dir": d["four"], "tp": 2},
        {"op": "restore_leaves", "dir": d["rows"],             # 1 → 4
         "spec": ("dp", None)},
        {"op": "save_leaves", "dir": d["rows_bad"], "spec": ("dp", None),
         "steps": (1, 2)},
        {"op": "adamw_resume", "dir": d["adamw"], "tp": 2},
    ]}, timeout=150)
    # a bit flip in rank 1's file of the newest row step
    f = os.path.join(d["rows_bad"], "step_00000002", "shards_p00001.bin")
    raw = bytearray(open(f, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(f, "wb").write(bytes(raw))
    two = run_world("checkpoint_ops", 2, root / "w2", {**common, "ops": [
        {"op": "restore_state", "dir": d["four"], "tp": 1},    # 4 → 2
        {"op": "save_state", "dir": d["two"], "tp": 1},
        {"op": "restore_leaves", "dir": d["rows"],             # cross axis
         "spec": (None, "dp")},
        {"op": "save_state", "dir": f"file://{d['two_remote']}",
         "tp": 1},                                  # the remote backend
        {"op": "restore_state", "dir": f"file://{d['two_remote']}",
         "tp": 1},
    ]}, timeout=150)
    three = run_world("checkpoint_ops", 3, root / "w3", {**common, "ops": [
        {"op": "restore_leaves", "dir": d["rows_bad"],         # 4 → 3
         "spec": ("dp", None)},
    ]}, timeout=150)
    with Checkpointer(d["four"]) as c:                         # 4 → 1
        one = c.restore_tree(abstract_train_state(cfg, device="cpu"))
        one_world = c.stored_world(7)
    return {"four": four, "two": two, "three": three,
            "one": (one, one_world), "params": params, "w": w, "dirs": d}


def _want_state(worlds):
    params = worlds["params"]
    return params, jax.tree.map(lambda p: p * 2 + 1, params)


def _assert_state(rec, worlds, n_writer):
    params, mu = _want_state(worlds)
    assert rec["step"] == 7 and rec["opt_step"] == 7
    assert rec["stored_world"] == n_writer
    assert rec["meta"] == {"world": n_writer}
    for got, want in ((rec["params"], params), (rec["mu"], mu)):
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_world_of_one_state_restores_into_four(worlds):
    for r in worlds["four"]:
        _assert_state(r[0], worlds, 1)
        assert r[0]["mesh"] == {"dp": 2, "sp": 1, "tp": 2}


def test_world_of_four_state_restores_into_two(worlds):
    for r in worlds["two"]:
        _assert_state(r[0], worlds, 4)
        assert r[0]["mesh"] == {"dp": 2, "sp": 1, "tp": 1}
        # the ZeRO-1 moments landed as slices: half of each leaf a rank
        assert r[0]["local_mu"][0] == (32, 32)        # embed [64, 32]


def test_world_of_four_state_restores_into_one(worlds):
    (tree, step, meta), stored = worlds["one"]
    params, mu = _want_state(worlds)
    assert step == 7 and stored == 4 and meta == {"world": 4}
    assert int(tree["opt"]["step"]) == 7
    for got, want in ((tree["params"], params), (tree["opt"]["mu"], mu)):
        for a, b in zip(jax.tree.leaves(params_to_numpy(got)),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_reshard_growth_one_to_four(worlds):
    w = worlds["w"]
    for rank, r in enumerate(worlds["four"]):
        rec = r[2]
        assert rec["step"] == 1
        assert rec["bounds"] == [[6 * rank, 6 * rank + 6], [0, 4]]
        np.testing.assert_array_equal(rec["piece"], (w + 1)[6 * rank:
                                                           6 * rank + 6])
        np.testing.assert_array_equal(rec["full"], w + 1)


def test_reshard_cross_axis_rows_to_columns(worlds):
    w = worlds["w"]
    for rank, r in enumerate(worlds["two"]):
        rec = r[2]
        assert rec["bounds"] == [[0, 24], [2 * rank, 2 * rank + 2]]
        np.testing.assert_array_equal(rec["piece"],
                                      (w + 1)[:, 2 * rank:2 * rank + 2])


def test_reshard_misaligned_shrink_quarantines_corrupt_step(worlds):
    """4 → 3 ranks (6-row records into 8-row pieces): the newest step has
    a flipped byte in a record only rank 0 and 1 need, yet every rank
    verifies every record, quarantines it and restores step 1 — no
    split brain."""
    w = worlds["w"]
    for rank, r in enumerate(worlds["three"]):
        rec = r[0]
        assert rec["step"] == 1
        assert rec["bounds"] == [[8 * rank, 8 * rank + 8], [0, 4]]
        np.testing.assert_array_equal(rec["piece"],
                                      (w + 1)[8 * rank:8 * rank + 8])
        assert any(q.startswith("step_00000002") for q in
                   rec["quarantined"])


def test_adamw_resume_bit_exact_in_a_world_of_four(worlds):
    for r in worlds["four"]:
        rec = r[4]
        assert rec["at"] == 3 and rec["meta"] == {"phase": "burnin"}
        assert rec["restored_equal"] and rec["final_equal"]
        assert rec["step_equal"]


def test_world_writes_one_shard_file_a_rank(worlds):
    d = worlds["dirs"]
    for name, n in (("four", 4), ("two", 2)):
        step = os.path.join(d[name], "step_00000007")
        files = sorted(f for f in os.listdir(step) if f.endswith(".bin"))
        assert files == [f"shards_p{k:05d}.bin" for k in range(n)]
        manifest = json.load(open(os.path.join(step, "manifest.json")))
        assert manifest["nprocs"] == n
    with Checkpointer(d["two"]) as c:
        assert c.stored_world(7) == 2


# ------------------------------------------------------- the remote backend


def _url(tmp_path, kind="memory"):
    """A fresh remote directory: ``memory://`` (per process, named after
    the test's directory) or ``file://``."""
    if kind == "memory":
        return f"memory://{tmp_path.name}-{os.getpid()}/ck"
    return f"file://{tmp_path / 'remote'}"


def _remote_files(url, step=None):
    import fsspec.core

    fs, root = fsspec.core.url_to_fs(url)
    sub = f"{root}/step_{step:08d}" if step is not None else root
    return fs, sorted(p[len(sub) + 1:] for p in fs.find(sub))


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_remote_roundtrip_and_layout(tmp_path, kind):
    """A remote step round-trips exactly, bf16 bits included, and holds
    the local layout file for file: manifest, meta, the rank's shard file
    and its part record."""
    cfg = _tiny_cfg(torch.bfloat16)
    params = _params(cfg)
    url = _url(tmp_path, kind)
    save_checkpoint(url, 3, params, meta={"last_loss": 1.25})
    assert latest_step(url) == 3
    restored, step, meta = restore_checkpoint(url, cfg, device="cpu")
    assert step == 3 and meta == {"last_loss": 1.25}
    assert _leaves_equal(params, restored)
    _, files = _remote_files(url, 3)
    assert files == ["manifest.json", "meta.json", "part_p00000.json",
                     "shards_p00000.bin"]
    with Checkpointer(url) as c:
        assert c.stored_world(3) == 1 and c.quarantined() == []


def test_remote_step_copied_local_restores_in_both_packages(tmp_path, jax8):
    """A ``memory://`` step of the AdamW train state, copied file by file
    to a local directory, is byte for byte what the local store writes
    (but the part record's nonce), and restores in the port's local
    ``Checkpointer`` and the JAX package's to equal arrays."""
    cfg = BurnInConfig(**INTEROP, dtype=torch.float32)
    init_state, _ = make_adamw_train_step(cfg, device="cpu")
    params = _params(cfg, seed=4)
    state = {"params": params, "opt": init_state(params)}
    url = _url(tmp_path)
    with Checkpointer(url) as c:
        c.save(5, state, meta={"from": "remote"})
    local = tmp_path / "local"
    with Checkpointer(str(local)) as c:
        c.save(5, state, meta={"from": "remote"})
    fs, files = _remote_files(url, 5)
    copy = tmp_path / "copy" / "step_00000005"
    copy.mkdir(parents=True)
    root = fsspec_root(url)
    for name in files:
        (copy / name).write_bytes(fs.cat_file(f"{root}/step_00000005/{name}"))
        if name != "part_p00000.json":
            assert (copy / name).read_bytes() == \
                (local / "step_00000005" / name).read_bytes(), name
    with Checkpointer(str(copy.parent)) as c:
        tree, step, meta = c.restore_tree(abstract_train_state(
            cfg, device="cpu"))
    assert step == 5 and meta == {"from": "remote"}
    assert _leaves_equal(state, tree)
    jcfg = jburnin.BurnInConfig(**INTEROP, dtype=jnp.float32)
    with jckpt.Checkpointer(str(copy.parent)) as c:
        jtree, at, _ = c.restore_tree(jopt.abstract_train_state(jcfg))
    assert at == 5
    got = dict(ckpt_mod._flatten(state))
    for path, w in jax.tree_util.tree_leaves_with_path(jtree):
        np.testing.assert_array_equal(
            _np_bits(w), _torch_bits(got[jax.tree_util.keystr(path)]))


def fsspec_root(url):
    import fsspec.core

    return fsspec.core.url_to_fs(url)[1]


def test_remote_crash_before_the_manifest_leaves_no_step(tmp_path,
                                                         monkeypatch):
    """The manifest is the commit point: a save that dies before writing
    it leaves a step directory with shards but no manifest, which is never
    listed or restored; the next save's sweep keeps it while it is young,
    and a clear removes it."""
    cfg = _tiny_cfg()
    url = _url(tmp_path)
    trees = _save_steps(url, cfg, (1,))
    real = ckpt_mod._RemoteStore._put_json

    def dies_at_commit(self, payload, *rel):
        if rel[-1] == ckpt_mod._MANIFEST:
            raise OSError("preempted mid-save")
        return real(self, payload, *rel)

    monkeypatch.setattr(ckpt_mod._RemoteStore, "_put_json", dies_at_commit)
    with pytest.raises(OSError, match="preempted"):
        save_checkpoint(url, 2, _params(cfg))
    monkeypatch.setattr(ckpt_mod._RemoteStore, "_put_json", real)
    fs, files = _remote_files(url)
    assert "step_00000002/shards_p00000.bin" in files
    assert "step_00000002/manifest.json" not in files
    with Checkpointer(url) as c:
        assert c.latest_step() == 1 and c.all_steps() == [1]
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 1 and _leaves_equal(trees[1], restored)
        c.save(3, trees[1])                   # sweeps only old crashes
        assert "step_00000002/shards_p00000.bin" in _remote_files(url)[1]
        assert c.clear() == 2
    assert _remote_files(url)[1] == []


@pytest.mark.parametrize("fault", ["truncate", "flip"])
def test_remote_corrupt_step_is_quarantined(tmp_path, fault):
    """A truncated shard or a flipped byte (the ranged read's length and
    crc32 checks) sends the step to ``quarantine/`` with its evidence,
    and restore falls back to the previous committed step."""
    cfg = _tiny_cfg()
    url = _url(tmp_path)
    trees = _save_steps(url, cfg, (1, 2))
    fs = _remote_files(url)[0]
    shard = f"{fsspec_root(url)}/step_00000002/shards_p00000.bin"
    raw = bytearray(fs.cat_file(shard))
    if fault == "truncate":
        raw = raw[:10]
    else:
        raw[len(raw) // 2] ^= 0xFF
    fs.pipe_file(shard, bytes(raw))
    with Checkpointer(url) as c:
        restored, step, _ = c.restore(cfg, device="cpu")
        assert step == 1 and _leaves_equal(trees[1], restored)
        assert c.all_steps() == [1]
        (q,) = c.quarantined()
        assert q.startswith("step_00000002.")
    evidence = _remote_files(url)[1]
    assert f"quarantine/{q}/shards_p00000.bin" in evidence
    assert f"quarantine/{q}/manifest.json" in evidence


def test_remote_retention_clear_and_async(tmp_path):
    """Retention keeps the newest steps (each old step's manifest goes
    first); async saves commit at flush; clear removes every committed
    step and keeps the quarantine."""
    cfg = _tiny_cfg()
    params = _params(cfg)
    url = _url(tmp_path)
    with Checkpointer(url, max_to_keep=2, async_save=True) as c:
        for s in (1, 2, 3, 4):
            c.save(s, _tree_map(lambda x: x + float(s), params),
                   meta={"s": s})
        c.flush()
        assert c.all_steps() == [3, 4]
        assert c.last_commit["bytes"] == sum(
            x.numel() * x.element_size() for x in tree_leaves(params))
        restored, step, meta = c.restore(cfg, device="cpu")
        assert step == 4 and meta == {"s": 4}
        assert _leaves_equal(_tree_map(lambda x: x + 4.0, params), restored)
        with pytest.raises(MissingStepError):
            c.restore(cfg, step=1, device="cpu")
        c._store.quarantine(3, "planted (for the test)")
        assert c.clear() == 1
        assert c.all_steps() == [] and len(c.quarantined()) == 1
    assert [f.split("/")[0] for f in _remote_files(url)[1]] == \
        ["quarantine"] * 4


def test_unknown_protocol_raises_naming_it(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ck = Checkpointer("nosuchfs://bucket/ck")
    for call in (ck.latest_step, ck.all_steps, ck.quarantined,
                 lambda: ck.save(1, _params(_tiny_cfg())),
                 lambda: ck.restore(_tiny_cfg(), device="cpu")):
        with pytest.raises(CheckpointError, match="nosuchfs:// protocol"):
            call()
    assert os.listdir(tmp_path) == []


def test_world_of_two_on_a_shared_file_url(worlds):
    """The world of 2 saves its train state through the remote backend on
    a shared ``file://`` directory (each rank its shard file and part,
    rank 0 the manifest after the rendezvous) and restores it; the step's
    manifest, meta and shards are the local world's byte for byte."""
    d = worlds["dirs"]
    for r in worlds["two"]:
        _assert_state(r[4], worlds, 2)
    remote = os.path.join(d["two_remote"], "step_00000007")
    local = os.path.join(d["two"], "step_00000007")
    names = sorted(os.listdir(remote))
    assert names == sorted(os.listdir(local)) == [
        "manifest.json", "meta.json", "part_p00000.json", "part_p00001.json",
        "shards_p00000.bin", "shards_p00001.bin"]
    for name in ("manifest.json", "meta.json", "shards_p00000.bin",
                 "shards_p00001.bin"):
        with open(os.path.join(remote, name), "rb") as a, \
                open(os.path.join(local, name), "rb") as b:
            assert a.read() == b.read(), name
