"""The benchmark's one door into the program under test, the port
``nvidia_terraform_modules_tpu_torch``: its configuration type, its serve
engine and admission interface, its train step, and its kernel library's
build state and launch counters. Imports happen on call, so importing
this module loads nothing of the port."""

from __future__ import annotations

MODEL_KEYS = ("vocab", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "n_layers", "attn", "rope", "flash_window", "n_experts",
              "router_top_k", "capacity_factor", "aux_loss_weight")


def config(m: dict, **over):
    """The port's ``BurnInConfig`` of configuration ``m``."""
    import torch

    from nvidia_terraform_modules_tpu_torch.models import BurnInConfig
    kw = {k: m[k] for k in MODEL_KEYS if k in m}
    return BurnInConfig(**kw, dtype=getattr(torch, m["dtype"]), **over)


def serve_engine(params, cfg, **kw):
    from nvidia_terraform_modules_tpu_torch.models import make_serve_engine
    return make_serve_engine(params, cfg, **kw)


def admission_base():
    from nvidia_terraform_modules_tpu_torch.models import AdmissionSource
    return AdmissionSource


def train_step(cfg, lr: float, device):
    from nvidia_terraform_modules_tpu_torch.models import make_train_step
    return make_train_step(cfg, lr=lr, device=device)


def build_kernels() -> bool:
    """Build (or find) the kernel library; True when this call compiled
    it."""
    from nvidia_terraform_modules_tpu_torch.ops import _build
    fresh = _build.library_path() is None
    _build.lib()
    return fresh


def launches() -> dict:
    """The kernel library's launch counts so far, kernel by kernel."""
    from nvidia_terraform_modules_tpu_torch.ops import _build
    return dict(_build.launches)
