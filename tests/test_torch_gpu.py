"""The port's CUDA kernels on the card (marked ``gpu``; they skip without a
CUDA device).  This file imports torch only, so it runs on a GPU machine
without JAX: ``python -m pytest -m gpu tests/test_torch_gpu.py``.

The kernels are held against their plain PyTorch versions on the same card
bit for bit (the plain version sums in the kernel's order and rounds after
every operation, as the kernel does)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineConfig
from repro_torch.core.history import unpack_words
from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.itp_stdp import kernel as K
from repro_torch.kernels.itp_stdp import ref as R
from repro_torch.kernels.itp_stdp.ops import po2_vectors
from repro_torch.serve import Request, ServeConfig, Server

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(lanes, n_pre, n_post, depth, seed, device):
    g = torch.Generator().manual_seed(seed)
    words = [torch.randint(0, 256, (lanes, n), generator=g, dtype=torch.uint8)
             for n in (n_pre, n_post)]
    x = dict(w=torch.rand((lanes, n_pre, n_post), generator=g),
             pre_s=(torch.rand((lanes, n_pre), generator=g) < 0.3).float(),
             post_s=(torch.rand((lanes, n_post), generator=g) < 0.3).float(),
             pre_w=words[0], post_w=words[1])
    x = {k: v.to(device) for k, v in x.items()}
    x["pre_b"], x["post_b"] = (unpack_words(x[k], depth).transpose(-1, -2).float().contiguous()
                               for k in ("pre_w", "post_w"))
    return x


@pytest.mark.parametrize("shape", ((2, 200, 72), (8, 784, 100), (1, 33, 5)))
@pytest.mark.parametrize("depth", (1, 7, 8))
def test_kernels_bit_equal_to_plain_versions(cuda, shape, depth):
    x = _inputs(*shape, depth, seed=depth, device=cuda)
    po2 = po2_vectors(STDPParams(), depth, device=cuda)
    for nearest in (True, False):
        kw = dict(nearest=nearest, eta=0.3, w_min=0.0, w_max=1.0)
        packed = K.itp_stdp_update_packed(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                          x["post_w"], *po2, depth=depth, **kw)
        unpacked = K.itp_stdp_update(x["w"], x["pre_s"], x["post_s"], x["pre_b"],
                                     x["post_b"], *po2, **kw)
        plain = R.itp_stdp_update_packed_ref(x["w"], x["pre_s"], x["post_s"], x["pre_w"],
                                             x["post_w"], *po2, depth=depth, **kw)
        torch.cuda.synchronize()
        assert torch.equal(packed, plain)
        assert torch.equal(unpacked, plain)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = _inputs(1, 16, 8, 7, seed=0, device=cuda)
    po2 = po2_vectors(STDPParams(), 7, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        K.itp_stdp_update_packed(x["w"].double(), x["pre_s"], x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)
    with pytest.raises(ValueError, match="is on cpu"):
        K.itp_stdp_update_packed(x["w"], x["pre_s"].cpu(), x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)
    with pytest.raises(ValueError, match="shape"):
        K.itp_stdp_update_packed(x["w"], x["pre_s"][:, :-1], x["post_s"], x["pre_w"],
                                 x["post_w"], *po2, depth=7)


def test_fused_serving_on_card_matches_reference(cuda):
    cfg = EngineConfig(n_pre=64, n_post=16, backend="fused")
    scfg = ServeConfig(max_batch=4, t_steps=8, theta_plus=0.05)
    rng = np.random.default_rng(0)
    load = [Request(f"u{i % 3}", (rng.random((8, 64)) < 0.05).astype(np.float32))
            for i in range(7)]
    results = {}
    for backend in ("fused", "reference"):
        server = Server(dataclasses.replace(cfg, backend=backend), scfg, device=cuda)
        K.itp_stdp_update_packed.launches = 0
        tickets = [server.submit(r) for r in load]
        server.drain()
        if backend == "fused":
            assert K.itp_stdp_update_packed.launches == server.batches * scfg.t_steps > 0
        results[backend] = (server, [server.poll(t) for t in tickets])
    (fs, fr), (rs, rr) = results["fused"], results["reference"]
    for a, b in zip(fr, rr):
        np.testing.assert_array_equal(a.post, b.post)
    for sid in fs.store.session_ids:
        a, b = fs.store.peek(sid), rs.store.peek(sid)
        assert all(torch.equal(p, q) for p, q in zip((*a.pre_words, *a.post_words),
                                                     (*b.pre_words, *b.post_words)))
        torch.testing.assert_close(a.w, b.w, rtol=1e-5, atol=1e-6)
