# SPDX-FileCopyrightText: Copyright (c) 2026 tpu-terraform-modules authors. All rights reserved.
# SPDX-License-Identifier: Apache-2.0
"""A/B timing of the port's kernels and the flagship train steps across
source trees of the port, on one card.

    python3 -m nvidia_terraform_modules_tpu_torch.utils.kernel_ab \\
        [--only GROUP,...] TREE_A TREE_B [TREE_C ...]

Each TREE is a directory that holds a copy of the package (e.g. a ``git
archive`` of the parent commit unpacked into an ignored directory, and
``.``). The trees run in turns — A, B, ..., then the same in reverse (for
two trees: OLD, NEW, NEW, OLD) — each in its own process with its own
kernel build, so every version is compared on one card and the spread
shows beside the difference. Each run prints one JSON line. The groups
(``--only`` picks some; all by default):

- ``fwd``: K1 at two serve prompt shapes and the train step's per-layer
  ``[2, 4096, 16, 128]``;
- ``decode``: K7 (bf16 paged decode) and K7-int8 at a flagship wave of 4
  slots (table widths 34 and 32 blocks of 16, the int8 engine's 256-row
  grain), and K6 at the int8 decode step (batch 8, 768 rows, positions
  512–568): device ms, and the host's median µs to issue one call;
- ``int8``: K8 at the four weight products of a flagship wave (square
  2048→2048, up 2048→8192, down 8192→2048, the tied head over ``[8192,
  2048]``) at M = 4, and the square at the decode step's M = 8: device ms,
  the host's median µs to issue one call, and the wave's mean per launch
  (32 square, 8 up, 8 down, 1 head); and the same timing of a
  single-element add, the floor the method (cold L2, spin, events) puts
  under every kernel;
- ``bwd``: K5/K3/K4 at the train shape;
- ``ring``: K2, and K5, K3 and K4 writing f32 (the ring's per-block
  gradients), at the ring's block ``[2, 1024, 16, 128]``, diagonal
  (causal) and visible (full);
- ``serve``: one flagship serve wave on 4 slots at position 305 of a
  456-row buffer, bf16 and int8 weights and pools, as the tree's engine
  runs it — one replay of the captured CUDA graph (``engine.capture``)
  where the tree has one, else the eager ``engine.step`` — and, in a tree
  with the graph, the eager step beside it: device ms (CUDA events) and
  the host's median ms to issue it; in a tree with ``spec_k``, one
  speculative trip (k = 4: a ``[4, 5]`` verification) replayed the same
  way;
- ``sample``: the flagship sampled wave (bf16, ``temperature=0.8,
  top_p=0.95``) as the engine replays it, with D1 drawing, against the
  same wave captured with the plain draw in D1's place (a graph built
  here, not an engine path), timed in turns plain, D1, D1, plain in one
  process, beside the greedy wave; and D1 and the plain draw alone on the
  wave's ``[4, 8192]`` logits;
- ``train``: the median host time of a flagship bf16 SGD step ending in a
  synchronise, and of the flagship ring SGD step (sp = 4 on the one card).

Kernel times are CUDA-event medians with a cold L2. A tree without a group's
entry points (an earlier slice) skips that group.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
from pathlib import Path

GROUPS = ("fwd", "decode", "int8", "bwd", "ring", "serve", "sample",
          "train")
# the flagship serve wave the serve and sample groups time: 4 slots at
# position 305 of a 456-row buffer
WAVE_SLOTS, WAVE_MAX_LEN, WAVE_POS, WAVE_BLOCK = 4, 456, 305, 16


def flagship_pool(models, cfg, dev, **kw):
    """A pool of the flagship wave: each slot mapped to a full table of its
    own blocks (the engine's table width: an int8 pool rounds to 256
    rows)."""
    import torch

    rows = models.cache_rows(WAVE_MAX_LEN, kw.get("cache_dtype", "bf16"))
    nt = -(-rows // WAVE_BLOCK)
    pool = models.init_paged_cache(cfg, WAVE_SLOTS, WAVE_MAX_LEN,
                                   block_size=WAVE_BLOCK,
                                   num_blocks=1 + WAVE_SLOTS * nt,
                                   device=dev, **kw)
    for i in range(WAVE_SLOTS):
        pool["block_tables"][i] = torch.arange(
            1 + i * nt, 1 + (i + 1) * nt, dtype=torch.int32)
    return pool


def sampled_waves(models, timing, dev, params, cfg,
                  sampler_kw=(("temperature", 0.8), ("top_p", 0.95))):
    """The flagship sampled wave replayed with D1 and with the plain draw
    captured in its place (plain, D1, D1, plain), and the greedy wave:
    device ms and host ms a wave; D1 and the plain draw alone on the
    wave's logits."""
    import torch

    decode = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.models.decode")
    serving = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.models.serving")
    sampling = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.ops.sampling")
    sampler = decode.make_sampler(**dict(sampler_kw))

    class PlainDraw(decode.Sampler):
        """The same filters, the plain draw (a debug graph's sampler)."""

        def rows(self, logits, key, fold):
            return sampling.draw_ref(self.filter(logits), key, None, fold)

    plain = PlainDraw(sampler.temperature, sampler.top_k, sampler.top_p)
    graphs = {}
    for name, smp in (("d1", sampler), ("plain", plain)):
        pool = flagship_pool(models, cfg, dev)
        step = serving.make_serve_step(params, cfg, smp)
        g = serving.WaveGraph(step, pool, sampled=True)
        g.active.fill_(True)
        g.fold.copy_(torch.tensor([[i, 40 + i] for i in range(WAVE_SLOTS)]))
        g.key.copy_(torch.tensor([0, 7]))
        graphs[name] = (g, pool)
    greedy_pool = flagship_pool(models, cfg, dev)
    greedy = serving.WaveGraph(serving.make_serve_step(params, cfg),
                               greedy_pool)
    greedy.active.fill_(True)

    def wave(g, pool):
        def run():
            pool["pos"].fill_(WAVE_POS)
            g.replay()
        return run

    out: dict = {"sampler": dict(sampler_kw),
                 "d1_launches_per_wave": graphs["d1"][0].launches,
                 "plain_launches_per_wave": graphs["plain"][0].launches}
    for turn, name in enumerate(("plain", "d1", "d1", "plain")):
        run = wave(*graphs[name])
        out[f"{name}_ms_per_wave_{turn}"] = timing.cuda_median_ms(run)
        out[f"{name}_host_ms_per_wave_{turn}"] = timing.host_ms(run, iters=30)
    for name in ("d1", "plain"):
        out[f"{name}_ms_per_wave"] = (out[f"{name}_ms_per_wave_1"]
                                      + out[f"{name}_ms_per_wave_2"]
                                      if name == "d1" else
                                      out[f"{name}_ms_per_wave_0"]
                                      + out[f"{name}_ms_per_wave_3"]) / 2
    run = wave(greedy, greedy_pool)
    out["greedy_ms_per_wave"] = timing.cuda_median_ms(run)
    out["greedy_host_ms_per_wave"] = timing.host_ms(run, iters=30)
    # the draw alone, on the wave's filtered logits
    g = torch.Generator(device=dev).manual_seed(3)
    logits = sampler.filter(torch.randn((WAVE_SLOTS, cfg.vocab),
                                        generator=g, device=dev) * 4)
    key = torch.tensor([0, 7], device=dev)
    fold = graphs["d1"][0].fold
    out["draw_d1_ms"] = timing.cuda_median_ms(
        lambda: sampling.draw(logits, key, None, fold))
    out["draw_plain_ms"] = timing.cuda_median_ms(
        lambda: sampling.draw_ref(logits, key, None, fold))
    return out


def spec_trip(models, timing, dev, params, cfg, k: int = 4) -> dict:
    """One speculative trip of the flagship engine (``spec_k = k``) over
    the wave's pool, every slot active: device and host ms a trip, as a
    replay of the captured graph."""
    import torch

    engine = models.make_serve_engine(params, cfg, max_len=WAVE_MAX_LEN,
                                      kv_block=WAVE_BLOCK, spec_k=k,
                                      device=dev)
    pool = flagship_pool(models, cfg, dev)
    graph = engine.capture(pool)
    st = graph.state
    g = torch.Generator(device=dev).manual_seed(4)
    st.ctx.copy_(torch.randint(0, cfg.vocab, st.ctx.shape, generator=g,
                               device=dev))
    st.active.fill_(True)
    st.n_new.fill_(10 ** 6)
    st.granted.fill_(WAVE_MAX_LEN)
    st.eos.fill_(-1)
    st.stop.fill_(WAVE_SLOTS)

    def trip():
        pool["pos"].fill_(WAVE_POS)
        st.cur.fill_(WAVE_POS + 1)
        st.n_out.fill_(1)
        st.fin.zero_()
        graph.replay()
    return {"spec_k": k, "spec_trip_launches": graph.launches,
            "spec_trip_ms": timing.cuda_median_ms(trip),
            "spec_trip_host_ms": timing.host_ms(trip, iters=30)}


def serve_wave(models, timing, dev) -> dict:
    """One flagship serve wave of the bf16 and the int8 engine: device and
    host milliseconds."""
    import torch

    cfg = models.BurnInConfig(**models.FLAGSHIP_TRAIN, dtype=torch.bfloat16)
    params = models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    toks = torch.zeros((WAVE_SLOTS,), dtype=torch.long, device=dev)
    active = torch.ones((WAVE_SLOTS,), dtype=torch.bool, device=dev)
    out = {}
    for name, p, kw in (
            ("serve", params, {}),
            ("serve_int8", models.quantize_params(params, dtype=torch.bfloat16),
             {"cache_dtype": "int8"})):
        engine = models.make_serve_engine(p, cfg, max_len=WAVE_MAX_LEN,
                                          kv_block=WAVE_BLOCK, device=dev,
                                          **kw)
        pool = flagship_pool(models, cfg, dev, **kw)

        def eager(engine=engine, pool=pool):
            pool["pos"].fill_(WAVE_POS)
            engine.step(toks, active, pool)

        waves = {"eager": eager}
        if hasattr(engine, "capture"):       # the wave as one replay
            graph = engine.capture(pool)
            graph.active.fill_(True)

            def replay(graph=graph, pool=pool):
                pool["pos"].fill_(WAVE_POS)
                graph.replay()
            waves = {"graph": replay, "eager": eager}
        out[f"{name}_route"] = next(iter(waves))
        for route, wave in waves.items():
            tag = name if route == out[f"{name}_route"] else \
                f"{name}_{route}"
            out[f"{tag}_ms_per_wave"] = timing.cuda_median_ms(wave)
            out[f"{tag}_host_ms_per_wave"] = timing.host_ms(wave, iters=30)
        del engine, pool, waves
    if hasattr(models, "make_spec_step"):
        out.update(spec_trip(models, timing, dev, params, cfg))
    return out


# K8 at a flagship wave: (name, M, K, N, [N, K] storage, products a wave)
INT8_PRODUCTS = (("square", 4, 2048, 2048, False, 32),
                 ("up", 4, 2048, 8192, False, 8),
                 ("down", 4, 8192, 2048, False, 8),
                 ("head", 4, 2048, 8192, True, 1),
                 ("square", 8, 2048, 2048, False, 0))


def int8_products(timing, dev) -> dict:
    """K8 at the wave's products (M = 4) and the decode step's square (M =
    8): device ms and the host's median µs a call; the wave's mean per
    launch; and the timing's floor."""
    import torch

    im = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.ops.int8_matmul")
    g = torch.Generator(device=dev).manual_seed(1)
    out, wave = {}, 0.0
    for name, m, k, n, trans, calls in INT8_PRODUCTS:
        w = torch.randint(-127, 128, (n, k) if trans else (k, n),
                          generator=g, device=dev, dtype=torch.int8)
        scale = torch.rand((n,), generator=g, device=dev) * 2e-3 + 1e-4
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()

        def call(x=x, w=w, scale=scale, trans=trans):
            return im.int8_matmul(x, w, scale, transpose_rhs=trans)
        key = f"int8_matmul_{name}_m{m}"
        out[f"{key}_ms"] = timing.cuda_median_ms(call, iters=20)
        out[f"{key}_host_us"] = timing.host_ms(call, iters=50) * 1e3
        wave += calls * out[f"{key}_ms"]
    out["int8_matmul_wave_mean_ms"] = wave / sum(
        c for *_, c in INT8_PRODUCTS)
    # what the timing itself costs a call: one single-element add
    one = torch.zeros((1,), device=dev)
    out["timing_floor_ms"] = timing.cuda_median_ms(lambda: one.add_(1),
                                                   iters=20)
    return out


def measure(tree: str, groups=GROUPS) -> dict:
    """Time the chosen groups of the package under ``tree``."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    fa = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.ops.flash_attention")
    models = importlib.import_module("nvidia_terraform_modules_tpu_torch.models")
    timing = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.utils.timing")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab measures on a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"tree": tree, "package": str(Path(fa.__file__).parents[1])}

    def randn(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    if "fwd" in groups:
        for b, s in ((1, 304), (1, 512), (2, 4096)):
            q, k, v = (randn((b, s, 16, 128)) for _ in range(3))
            out[f"flash_fwd_{b}x{s}_ms"] = timing.cuda_median_ms(
                lambda: fa.flash_attention_fwd(q, k, v))
    if "decode" in groups:
        da = importlib.import_module(
            "nvidia_terraform_modules_tpu_torch.ops.decode_attention")
        pos = torch.tensor([320, 208, 176, 240], dtype=torch.int32,
                           device=dev)
        qd = randn((4, 16, 128))
        for name, nt, int8 in (("paged_decode", 34, False),
                               ("paged_decode_int8", 32, True)):
            pool = [randn((1 + 4 * nt, 16, 16, 128), torch.float32)
                    for _ in range(2)]
            kw = {}
            if int8:
                (kp, ks), (vp, vs) = (models.quantize_kv(t) for t in pool)
                pool, kw = [kp, vp], dict(k_scale=ks, v_scale=vs)
            else:
                pool = [t.bfloat16() for t in pool]
            tables = torch.arange(1, 1 + 4 * nt, dtype=torch.int32,
                                  device=dev).reshape(4, nt)
            def call(pool=pool, tables=tables, kw=kw):
                return da.paged_decode_attention(qd, *pool, tables, pos,
                                                 scale=128 ** -0.5, **kw)

            out[f"{name}_4x16_ms"] = timing.cuda_median_ms(call)
            out[f"{name}_host_us"] = timing.host_ms(call, iters=50) * 1e3
        (kc, ks), (vc, vs) = (models.quantize_kv(
            randn((8, 768, 16, 128), torch.float32)) for _ in range(2))
        pos8 = torch.arange(512, 576, 8, dtype=torch.int32, device=dev)
        q8 = randn((8, 16, 128))
        def call6():
            return da.kv_decode_attention(q8, kc, vc, pos8,
                                          scale=128 ** -0.5, k_scale=ks,
                                          v_scale=vs)

        out["kv_decode_int8_8x768_ms"] = timing.cuda_median_ms(call6)
        out["kv_decode_int8_host_us"] = timing.host_ms(call6, iters=50) * 1e3
    if "int8" in groups:
        out.update(int8_products(timing, dev))
    if "serve" in groups:
        out.update(serve_wave(models, timing, dev))
    if "sample" in groups and hasattr(models, "make_sampler"):
        cfg = models.BurnInConfig(**models.FLAGSHIP_TRAIN,
                                  dtype=torch.bfloat16)
        params = models.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
        out.update({f"sample_{k}": v for k, v in sampled_waves(
            models, timing, dev, params, cfg).items()})
        del params
    if not hasattr(fa, "flash_dqdkv"):   # a tree from before the train step
        return out
    q, k, v, do = (randn((2, 4096, 16, 128)) for _ in range(4))
    if "bwd" in groups:
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * o.float()).sum(-1).permute(0, 2, 1) \
            .contiguous()
        args = (q, k, v, do, lse, delta)
        for name in ("flash_dqdkv", "flash_dq", "flash_dkv"):
            fn = getattr(fa, name)
            out[f"{name}_ms"] = timing.cuda_median_ms(
                lambda fn=fn: fn(*args, scale=128 ** -0.5))
    if "ring" in groups and hasattr(fa, "flash_partial"):
        qr, kr, vr, dor = (t[:, :1024].contiguous() for t in (q, k, v, do))
        for name, causal in (("diag", True), ("visible", False)):
            out[f"flash_partial_{name}_ms"] = timing.cuda_median_ms(
                lambda causal=causal: fa.flash_partial(
                    qr, kr, vr, scale=128 ** -0.5, causal=causal))
            # the ring's per-block backward: K5, K3 and K4 writing f32
            o_r, lse_r = fa.flash_attention_fwd(qr, kr, vr, causal=causal)
            delta_r = (dor.float() * o_r.float()).sum(-1).permute(0, 2, 1) \
                .contiguous()
            args_r = (qr, kr, vr, dor, lse_r, delta_r)
            for fn_name in ("flash_dqdkv", "flash_dq", "flash_dkv"):
                out[f"{fn_name}_f32_out_{name}_ms"] = timing.cuda_median_ms(
                    lambda fn=getattr(fa, fn_name), args_r=args_r,
                    causal=causal: fn(*args_r, scale=128 ** -0.5,
                                      causal=causal,
                                      out_dtype=torch.float32))
    if "train" not in groups:
        return out
    del q, k, v, do
    cfg = models.BurnInConfig(**models.FLAGSHIP_TRAIN, dtype=torch.bfloat16)
    state = {"p": models.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)}
    batch = models.synthetic_batch(
        torch.Generator(device=dev).manual_seed(2), cfg, device=dev)
    step = models.make_train_step(cfg, lr=0.1, device=dev)

    def run():
        state["p"], loss = step(state["p"], batch)
        return loss

    timing.synced_ms(run, 1)                # warm-up
    losses, out["train_step_ms"] = timing.synced_ms(run, 5)
    out["last_loss"] = losses[-1].item()
    if not hasattr(fa, "flash_partial"):    # a tree from before the ring
        return out
    parallel = importlib.import_module(
        "nvidia_terraform_modules_tpu_torch.parallel")
    rules = parallel.make_rules(parallel.build_mesh(
        parallel.plan_mesh(4, tp=1, sp=4), devices=[dev] * 4))
    ring_step = models.make_train_step(
        dataclasses.replace(cfg, attn="ring"), rules, lr=0.1, device=dev)

    def ring_run():
        state["p"], loss = ring_step(state["p"], batch)
        return loss

    timing.synced_ms(ring_run, 1)           # warm-up
    losses, out["ring_step_ms"] = timing.synced_ms(ring_run, 5)
    out["ring_last_loss"] = losses[-1].item()
    return out


def main(argv: list[str]) -> int:
    groups = GROUPS
    if argv[:1] == ["--only"] and len(argv) > 1:
        groups = tuple(argv[1].split(","))
        argv = argv[2:]
        if not set(groups) <= set(GROUPS):
            print(f"--only takes groups of {GROUPS}", file=sys.stderr)
            return 2
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(measure(argv[1], groups)), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in argv + argv[::-1]:
        run = subprocess.run([sys.executable, __file__, "--only",
                              ",".join(groups), "--one", tree],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            print(run.stderr, file=sys.stderr)
            return run.returncode
        print(run.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
