"""KV-cache containers for decode, including int8-quantised storage (port of
``repro.models.kvcache``; ROADMAP item 18b).

The int8 path stores per-(token, head) symmetric scales — amax over the
head_dim vector — so dequantisation is one elementwise multiply on the
attention read path.  The codes are the reference's bit for bit.

The cache lives in place: :func:`cache_write` writes its slot into the
tensors it is given and returns them (the reference returns new arrays
and relies on buffer donation).  Like the reference's
``jax.lax.dynamic_update_slice`` (``kvcache.py:59-66``), a write whose slot
lies past the end is clamped to the last slot that fits: with ``slot ≥ T``
a one-token write lands in slot ``T - 1``, silently (ROADMAP queue 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.layers import init_device


class KVCache(NamedTuple):
    """Stacked-over-layers cache: k/v (L, B, T, K, hd)."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None   # (L, B, T, K, 1) when int8
    v_scale: torch.Tensor | None = None

    @property
    def quantised(self) -> bool:
        return self.k.dtype == torch.int8


def init_kv_cache(n_layers: int, batch: int, max_t: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16, *,
                  device: str | torch.device = "cuda") -> KVCache:
    dev = init_device(device)
    shape = (n_layers, batch, max_t, n_kv, head_dim)
    if dtype == torch.int8:
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=dev),
            v=torch.zeros(shape, dtype=torch.int8, device=dev),
            k_scale=torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=dev),
            v_scale=torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev))


def quantise_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, hd) → (int8 values, float32 scale (…, 1)); round half to even."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantise_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def clamped_start(slot: int, extent: int, size: int) -> int:
    """``jax.lax.dynamic_update_slice``'s start index: ``slot`` clamped so
    that an update of ``extent`` fits in ``size``."""
    return min(max(int(slot), 0), size - extent)


def cache_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
                k_new: torch.Tensor, v_new: torch.Tensor, slot: int):
    """Write one step's K/V at ``slot`` into a single layer's (B,T,K,hd)
    slice, in place (``slot`` clamped as the module docstring says); returns
    the four tensors it was given."""
    n = k_new.shape[1]
    at = clamped_start(slot, n, cache_k.shape[1])
    if cache_k.dtype == torch.int8:
        kq, ks = quantise_kv(k_new)
        vq, vs = quantise_kv(v_new)
        cache_k[:, at:at + n] = kq
        cache_v[:, at:at + n] = vq
        k_scale[:, at:at + n] = ks
        v_scale[:, at:at + n] = vs
    else:
        cache_k[:, at:at + n] = k_new.to(cache_k.dtype)
        cache_v[:, at:at + n] = v_new.to(cache_v.dtype)
    return cache_k, cache_v, k_scale, v_scale


def cache_read(cache_k: torch.Tensor, cache_v: torch.Tensor,
               k_scale: torch.Tensor | None, v_scale: torch.Tensor | None,
               dtype: torch.dtype = torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    if cache_k.dtype == torch.int8:
        return (dequantise_kv(cache_k, k_scale, dtype),
                dequantise_kv(cache_v, v_scale, dtype))
    return cache_k.to(dtype), cache_v.to(dtype)
