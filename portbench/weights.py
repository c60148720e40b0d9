"""Seeded weights for a configuration, made on the device in a few large
calls and in the type they are served in, in the port's parameter layout
(``embed``, ``out_norm``, ``layers[i]`` with ``attn_norm``, ``wq``,
``wk``, ``wv``, ``wo``, ``mlp_norm`` and ``up``/``down`` or ``moe``
``{router, experts_up, experts_down}``). The same seed gives the same
values; both the program and the reference are handed them."""

from __future__ import annotations

import hashlib

import torch

SCALE = 0.02          # normal · 0.02, the burn-in model's init scale


def derive_seed(seed: int, salt: str) -> int:
    """A 63-bit generator seed from the run's seed and a purpose."""
    digest = hashlib.sha256(f"{salt}-{seed}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def model_dtype(config: dict) -> torch.dtype:
    return getattr(torch, config["dtype"])


def make(config: dict, seed: int, device) -> dict:
    """Weights of ``config`` from ``seed`` on ``device``: each kind of
    leaf drawn for all layers in one call, norms at one, the router in
    f32."""
    dev = torch.device(device)
    dt = model_dtype(config)
    g = torch.Generator(device=dev).manual_seed(derive_seed(seed, "weights"))
    n, d, f, v = (config["n_layers"], config["d_model"], config["d_ff"],
                  config["vocab"])
    heads = config["n_heads"]
    kv = (config.get("n_kv_heads") or heads) * (d // heads)
    e = config.get("n_experts", 0)

    def normal(shape, dtype=dt):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).mul_(SCALE)

    embed = normal((v, d))
    attn = normal((n, 2 * d * d + 2 * d * kv))
    ones = torch.ones((2 * n + 1, d), dtype=dt, device=dev)
    if e:
        router = normal((n, d, e), torch.float32)
        ups, downs = normal((n, e, d, f)), normal((n, e, f, d))
    else:
        ups, downs = normal((n, d, f)), normal((n, f, d))
    layers = []
    for i in range(n):
        a = attn[i]
        cut = [d * d, d * kv, d * kv, d * d]
        wq, wk, wv, wo = a.split(cut)
        layer = {"attn_norm": ones[2 * i], "wq": wq.view(d, d),
                 "wk": wk.view(d, kv), "wv": wv.view(d, kv),
                 "wo": wo.view(d, d), "mlp_norm": ones[2 * i + 1]}
        if e:
            layer["moe"] = {"router": router[i], "experts_up": ups[i],
                            "experts_down": downs[i]}
        else:
            layer["up"], layer["down"] = ups[i], downs[i]
        layers.append(layer)
    return {"embed": embed, "out_norm": ones[2 * n], "layers": layers}


def leaves(params: dict) -> list[tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, in a fixed order."""
    out = [("embed", params["embed"]), ("out_norm", params["out_norm"])]
    for i, layer in enumerate(params["layers"]):
        for k, t in layer.items():
            if isinstance(t, dict):
                out += [(f"layers.{i}.{k}.{kk}", tt) for kk, tt in t.items()]
            else:
                out.append((f"layers.{i}.{k}", t))
    return out


def to_float(params: dict) -> dict:
    """An f32 copy in the same layout (what the reference computes in)."""
    def conv(t):
        return {k: conv(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.to(torch.float32, copy=True)
    return {"embed": conv(params["embed"]),
            "out_norm": conv(params["out_norm"]),
            "layers": [conv(layer) for layer in params["layers"]]}

