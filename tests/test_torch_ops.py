"""The port's eleven kernels as registered torch operators (``kernels/_ops.py``):
each ``torch.ops.repro_torch.<name>`` has a CPU kernel (the plain version), a
CUDA kernel (the launch) and a fake kernel, and no composite or default
kernel that could run the plain version on CUDA tensors.  On the CPU each
passes ``torch.library.opcheck``, computes its plain version bit for bit,
and a fake call (a trace) launches and counts nothing."""
import importlib

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.itp_counter import kernel as counter_kernel
from repro_torch.kernels.itp_counter import ref as counter_ref
from repro_torch.kernels.itp_counter.ops import counter_lut
from repro_torch.kernels.itp_stdp import kernel as dense_kernel
from repro_torch.kernels.itp_stdp import ref as dense_ref
from repro_torch.kernels.itp_stdp.ops import po2_vectors
from repro_torch.kernels.itp_stdp_conv import kernel as conv_kernel
from repro_torch.kernels.itp_stdp_conv import ref as conv_ref
from repro_torch.kernels.lif import kernel as lif_kernel
from repro_torch.kernels.lif import ref as lif_ref
from repro_torch.kernels.llsmu import kernel as llsmu_kernel
from repro_torch.kernels.llsmu import ref as llsmu_ref
from repro_torch.kernels.po2_quant import kernel as po2_kernel
from repro_torch.kernels.po2_quant import ref as po2_ref

DEPTH = 7
WINDOW = dict(depth=DEPTH, window="exact", a_plus=1.0, a_minus=1.125, tau_plus=4.0,
              tau_minus=4.0)
CLIP = dict(eta=0.0625, w_min=0.0, w_max=1.0)


def _spikes(rng, shape):
    return torch.from_numpy((rng.random(shape) < 0.4).astype(np.float32))


def _words(rng, shape, high=1 << DEPTH):
    return torch.from_numpy(rng.integers(0, high, shape).astype(np.uint8))


def _cases():
    """name → (wrapper, plain version, args, kwargs), CPU inputs from a seed;
    the dense updates with two lanes."""
    rng = np.random.default_rng(0)
    ltp, ltd = po2_vectors(STDPParams(), DEPTH)
    w = torch.from_numpy(rng.random((2, 12, 5)).astype(np.float32))
    pre, post = _spikes(rng, (2, 12)), _spikes(rng, (2, 5))
    planes_pre = _spikes(rng, (2, DEPTH, 12))
    planes_post = _spikes(rng, (2, DEPTH, 5))
    patches, out = _spikes(rng, (30, 9)), _spikes(rng, (30, 4))
    lut = counter_lut(STDPParams(), DEPTH)
    counters = (_words(rng, (2, 12), DEPTH + 1), _words(rng, (2, 5), DEPTH + 1))
    conv_counters = (_words(rng, (30, 9), DEPTH + 1), _words(rng, (30, 4), DEPTH + 1))
    v = torch.from_numpy(rng.normal(0.5, 0.4, (4, 33)).astype(np.float32))
    i_in = torch.from_numpy(rng.normal(0.2, 0.3, (4, 33)).astype(np.float32))
    a = torch.from_numpy(rng.integers(0, 1 << 12, (4, 33)).astype(np.int32))
    b = torch.from_numpy(rng.integers(0, 1 << 12, (4, 33)).astype(np.int32))
    x = torch.from_numpy(rng.normal(0, 1e-2, (5, 31)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, 256, (5, 31)).astype(np.int32))
    return {
        "itp_stdp_update_packed": (
            dense_kernel.itp_stdp_update_packed, dense_ref.itp_stdp_update_packed_ref,
            (w, pre, post, _words(rng, (2, 12)), _words(rng, (2, 5)), ltp, ltd),
            dict(depth=DEPTH, nearest=True, **CLIP)),
        "itp_stdp_update": (
            dense_kernel.itp_stdp_update, dense_ref.itp_stdp_update_ref,
            (w, pre, post, planes_pre, planes_post, ltp, ltd), dict(nearest=False, **CLIP)),
        "itp_stdp_conv_delta_packed": (
            conv_kernel.itp_stdp_conv_delta_packed, conv_ref.itp_stdp_conv_delta_packed_ref,
            (patches, out, _words(rng, (30, 9)), _words(rng, (30, 4)), ltp, ltd),
            dict(depth=DEPTH, nearest=True)),
        "itp_stdp_conv_delta": (
            conv_kernel.itp_stdp_conv_delta, conv_ref.itp_stdp_conv_delta_ref,
            (patches, out, _spikes(rng, (DEPTH, 30, 9)), _spikes(rng, (DEPTH, 30, 4)),
             ltp, ltd), dict(nearest=True)),
        "counter_stdp_update": (
            counter_kernel.counter_stdp_update,
            lambda *args, **kw: counter_ref.counter_stdp_update_ref(*args[:5], lut=args[5],
                                                                    **kw),
            (w, pre, post, *counters, lut), dict(WINDOW, **CLIP)),
        "counter_conv_delta": (
            counter_kernel.counter_conv_delta,
            lambda *args, **kw: counter_ref.counter_conv_delta_ref(*args[:4], lut=args[4],
                                                                   **kw),
            (patches, out, *conv_counters, lut), dict(WINDOW, window="imstdp")),
        "counter_fc_delta": (
            counter_kernel.counter_fc_delta,
            lambda *args, **kw: counter_ref.counter_fc_delta_ref(*args[:4], lut=args[4], **kw),
            (pre, post, *counters, lut), dict(WINDOW, window="linear")),
        "lif_update": (lif_kernel.lif_update, lif_ref.lif_update_ref, (v, i_in),
                       dict(alpha=0.9, e_rest=0.0, v_th=1.0)),
        "llsmu_multiply": (llsmu_kernel.llsmu_multiply, llsmu_ref.llsmu_multiply_ref, (a, b),
                           dict(n_bits=4, frac_bits=12, c=0.08333)),
        "po2_encode": (po2_kernel.po2_encode, po2_ref.po2_encode_ref, (x,), {}),
        "po2_decode": (po2_kernel.po2_decode, po2_ref.po2_decode_ref, (codes,), {}),
    }


CASES = _cases()
NAMES = sorted(CASES)


def _op(name):
    return getattr(torch.ops.repro_torch, name)


def _defined():
    return sorted(op for op in torch._C._dispatch_get_all_op_names()
                  if op.startswith("repro_torch::"))


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_ten_ops_in_one_namespace():
    """The ten ported kernels and the counter fc delta."""
    assert len(NAMES) == 11
    assert _defined() == sorted(f"repro_torch::{n}" for n in NAMES)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("test", ["test_schema", "test_faketensor",
                                  "test_autograd_registration", "test_aot_dispatch_dynamic"])
def test_opcheck(name, test):
    _, _, args, kwargs = CASES[name]
    torch.library.opcheck(_op(name).default, args, kwargs, test_utils=(test,))


@pytest.mark.parametrize("name", NAMES)
def test_cpu_op_and_wrapper_equal_the_plain_version(name):
    wrapper, plain, args, kwargs = CASES[name]
    want = plain(*args, **kwargs)
    assert _equal(_op(name)(*args, **kwargs), want)
    assert _equal(wrapper(*args, **kwargs), want)


def test_llsmu_scalar_b_equals_the_plain_version_on_a_broadcast_b():
    _, _, (a, b), kw = CASES["llsmu_multiply"]
    one = b.reshape(-1)[:1].clone()
    want = llsmu_ref.llsmu_multiply_ref(a, one.expand_as(a), **kw)
    assert _equal(_op("llsmu_multiply")(a, one, **kw), want)
    with FakeTensorMode() as mode:
        fake = _op("llsmu_multiply")(mode.from_tensor(a), mode.from_tensor(one), **kw)
    assert fake.shape == a.shape and fake.dtype == torch.int32


@pytest.mark.parametrize("name", NAMES)
def test_cpu_and_cuda_kernels_and_no_composite(name):
    qualified = f"repro_torch::{name}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(qualified, "CPU") and has(qualified, "CUDA") and has(qualified, "Meta")
    for key in ("CompositeImplicitAutograd", "CompositeExplicitAutograd",
                "CompositeExplicitAutogradNonFunctional"):
        assert not has(qualified, key), key


@pytest.mark.parametrize("name", NAMES)
def test_fake_call_has_the_shapes_and_counts_no_launch(name):
    wrapper, plain, args, kwargs = CASES[name]
    want = plain(*args, **kwargs)
    wrapper.launches = 0
    with FakeTensorMode() as mode:
        fake = wrapper(*[mode.from_tensor(t) for t in args], **kwargs)
    for got, ref in zip(fake if isinstance(fake, tuple) else (fake,),
                        want if isinstance(want, tuple) else (want,)):
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert got.stride() == ref.stride()
    assert wrapper.launches == 0


@pytest.mark.parametrize("name", NAMES)
def test_fake_kernels_refuse_what_the_launch_refuses(name):
    """A trace holds the launch's shape and dtype rules: an operand one
    element short, or a conv delta's patches with a third axis, is refused."""
    _, _, args, kwargs = CASES[name]
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(t) for t in args]
        broken = list(fake)
        if name.endswith("conv_delta") or name.endswith("conv_delta_packed"):
            broken[0] = fake[0][None]
        elif len(fake) > 1:
            broken[1] = fake[1][..., :-1]
        else:
            broken[0] = fake[0].to(torch.float64)
        with pytest.raises((ValueError, TypeError)):
            _op(name)(*broken, **kwargs)


@pytest.mark.parametrize("module", [dense_kernel, conv_kernel, counter_kernel, lif_kernel,
                                    llsmu_kernel, po2_kernel])
def test_a_module_imported_again_defines_no_op_twice(module):
    before = _defined()
    importlib.reload(module)
    assert _defined() == before
    name = {dense_kernel: "itp_stdp_update_packed", conv_kernel: "itp_stdp_conv_delta",
            counter_kernel: "counter_stdp_update", lif_kernel: "lif_update",
            llsmu_kernel: "llsmu_multiply", po2_kernel: "po2_encode"}[module]
    wrapper, plain, args, kwargs = CASES[name]
    assert _equal(getattr(module, name)(*args, **kwargs), plain(*args, **kwargs))
