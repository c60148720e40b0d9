# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""PyTorch port, the collective probes over a ``torch.distributed`` world
(``parallel/collectives.py``) against the JAX reference's.

One gloo world of 4 CPU ranks (``_torch_world.py``) runs the five probes on
the flat mesh (dp 4) and on the 2 × 2 multislice mesh (slice × dp) over
each axis, a ring hop on an axis of one (no rank may send to itself), the
hierarchical psum's probe, the hierarchical psum of seeded numpy inputs
beside a flat all-reduce of the same, and a psum probe with a fault
planted on one rank. The reference's probes on the same mesh shapes count
the same bytes and participants; the hierarchical psum equals the flat
all-reduce and the numpy sum within 1e-6.
"""

import jax
import numpy as np
import pytest
from _torch_world import run_world

from nvidia_terraform_modules_tpu.parallel import collectives as jcoll
from nvidia_terraform_modules_tpu.parallel import (
    build_mesh as jbuild_mesh,
    build_multislice_mesh as jbuild_multislice,
    plan_mesh as jplan_mesh,
    plan_multislice as jplan_multislice,
)

PROBES = ("psum", "all_gather", "reduce_scatter", "ring_permute",
          "all_to_all")
INPUTS = np.random.default_rng(3).standard_normal((4, 37)).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_world("collectives", 4, tmp_path_factory.mktemp("coll"),
                     {"inputs": INPUTS}, timeout=120)


@pytest.mark.parametrize("name", PROBES)
def test_probe_on_flat_mesh(ranks, name):
    for r in ranks:
        got = r["flat"][name]
        assert got["ok"] is True and got["participants"] == 4, got
        assert got["max_error"] <= 1e-5 and got["seconds"] > 0
    # every rank returns the world's verdict, error and time
    assert len({(r["flat"][name]["max_error"], r["flat"][name]["seconds"])
                for r in ranks}) == 1


@pytest.mark.parametrize("axis", ["slice", "dp"])
@pytest.mark.parametrize("name", PROBES)
def test_probe_on_multislice_axes(ranks, name, axis):
    for r in ranks:
        got = r[axis][name]
        assert got["ok"] is True and got["participants"] == 2, got


def test_psum_error_is_zero_and_a_planted_fault_fails_every_rank(ranks):
    for r in ranks:
        assert r["flat"]["psum"]["max_error"] == 0.0
        planted = r["planted"]
        assert planted["ok"] is False
        assert planted["max_error"] == pytest.approx(0.5)


def test_ring_on_an_axis_of_one_sends_nothing(ranks):
    for r in ranks:
        got = r["ring_of_one"]
        assert got["ok"] is True and got["participants"] == 1
        assert got["bytes"] == 64 * 4


def test_multislice_mesh_is_slice_major(ranks):
    for rank, r in enumerate(ranks):
        coords, dp_line, slice_line = r["coords"]
        assert coords == {"slice": rank // 2, "dp": rank % 2, "sp": 0,
                          "tp": 0}
        assert dp_line == [2 * (rank // 2), 2 * (rank // 2) + 1]
        assert slice_line == [rank % 2, rank % 2 + 2]


def test_hierarchical_psum_equals_flat_all_reduce_and_numpy_sum(ranks):
    want = INPUTS.sum(axis=0)
    for r in ranks:
        assert r["hier"].shape == (37,)
        assert np.abs(r["hier"] - r["flat_sum"]).max() <= 1e-6
        assert np.abs(r["hier"] - want).max() <= 1e-6
        probe = r["hier_probe"]
        assert probe["ok"] is True and probe["participants"] == 4


def test_bytes_and_participants_match_reference(ranks, jax8):
    """The reference's probes on the same shapes (4 devices on dp; the
    2 × 2 multislice mesh) count the same bytes and participants."""
    flat = jbuild_mesh(jplan_mesh(4, tp=1), devices=jax.devices()[:4])
    for name in PROBES:
        want = jcoll.ALL_PROBES[name](flat, axis="dp", n_elems=256)
        got = ranks[0]["flat"][name]
        assert want["ok"] is True
        assert got["bytes"] == want["bytes"], name
        assert got["participants"] == want["participants"], name
    ms = jbuild_multislice(jplan_multislice(4, 2, tp=1),
                           devices=jax.devices()[:4])
    want = jcoll.hierarchical_psum_probe(ms, n_elems=257)
    got = ranks[0]["hier_probe"]
    for key in ("bytes", "participants", "ici_bytes", "dcn_bytes"):
        assert got[key] == want[key], key
