"""The port's last two legacy scans against the JAX package on the CPU:
B6b ``ivf_scan_clustermajor`` (plain version against the Pallas kernel in
interpret mode, over the sweep of ``tests/test_kernels.py``) and B7
``ivf_scan_q8`` (plain version against the Pallas kernel in interpret mode,
as ``tests/test_quantize.py`` holds it against ``ivf_scan_quantized``).
The same numpy inputs go to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from _torch_port import q8_case, torch_threads  # noqa: E402,F401


def _cmajor_inputs(c, l, d, b, a_n, seed, out_of_range=False):
    rng = np.random.default_rng(seed)
    post = rng.normal(size=(c, l, d)).astype(np.float32)
    queries = rng.normal(size=(b, d)).astype(np.float32)
    lo, hi = (-3, c + 3) if out_of_range else (0, c)
    active = rng.integers(lo, hi, size=a_n).astype(np.int32)
    qsel = rng.random((a_n, b)) < 0.5
    return post, active, qsel, queries


@pytest.mark.parametrize("c,l,d,b,a_n,oor", [
    (16, 8, 16, 4, 6, False), (32, 16, 32, 8, 12, False),   # the JAX sweep
    (10, 12, 20, 13, 9, True),       # ragged B, out-of-range active ids
])
def test_clustermajor_plain_matches_jax_kernel(c, l, d, b, a_n, oor):
    from repro.kernels.ivf_scan import ivf_scan_clustermajor as jax_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels.ivf_scan import ivf_scan_clustermajor_plain

    post, active, qsel, q = _cmajor_inputs(c, l, d, b, a_n, seed=a_n + d,
                                           out_of_range=oor)
    want = np.asarray(jax_kernel(jnp.asarray(post), jnp.asarray(active),
                                 jnp.asarray(qsel), jnp.asarray(q),
                                 interpret=True))
    args = [torch.from_numpy(a) for a in (post, active, qsel, q)]
    got = ivf_scan_clustermajor_plain(*args).numpy()
    assert got.shape == (a_n, l, b)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isinf(got.transpose(0, 2, 1)[~qsel]).all()
    np.testing.assert_array_equal(ops.ivf_scan_clustermajor(*args).numpy(),
                                  got)


def test_clustermajor_plain_matches_jax_oracle_and_keeps_nan():
    from repro.kernels.ref import ivf_scan_clustermajor_ref as jax_ref
    from repro_torch.kernels.ivf_scan import ivf_scan_clustermajor_plain

    post, active, qsel, q = _cmajor_inputs(9, 8, 12, 5, 7, seed=3)
    post[active[0], 2, 5] = np.nan
    qsel[0] = True
    want = np.asarray(jax_ref(*(jnp.asarray(a)
                                for a in (post, active, qsel, q))))
    got = ivf_scan_clustermajor_plain(
        *(torch.from_numpy(a) for a in (post, active, qsel, q))).numpy()
    assert np.isnan(want[0, 2]).all()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("c,l,d,b,p,masked", [
    (24, 16, 24, 4, 6, 0.3),         # the shape of tests/test_quantize.py
    (40, 48, 32, 13, 7, 0.4),        # ragged B
    (9, 8, 1024, 3, 4, 0.0),         # D 1024
])
def test_q8_legacy_plain_matches_jax_kernel(c, l, d, b, p, masked):
    from repro.core.quantize import QuantizedPostings as JQP
    from repro.core.quantize import ivf_scan_quantized as jax_quantized
    from repro.kernels.ivf_scan_q8 import ivf_scan_q8 as jax_kernel
    from repro_torch.kernels import ops
    from repro_torch.kernels.ivf_scan_q8 import ivf_scan_q8_plain

    q8, scale, norm2, cents, _, cids, mask, q = q8_case(
        c, l, d, b, p, seed=c + d, dead=0.2, masked=masked, dup=True)
    cids[0, -1] = c + 4                  # out of range: clipped to C - 1
    cids[-1, 0] = -2                     # out of range: clipped to 0
    jargs = [jnp.asarray(a) for a in (q8, scale, norm2, cents, cids, mask, q)]
    want = np.asarray(jax_kernel(*jargs, interpret=True))
    yard = np.asarray(jax_quantized(JQP(*jargs[:3]), *jargs[3:]))
    targs = [torch.from_numpy(a) for a in
             (q8, scale, norm2, cents, cids, mask, q)]
    got = ivf_scan_q8_plain(*targs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(got, yard, rtol=1e-4, atol=1e-3)
    assert (got[~mask] == np.inf).all()
    assert np.isfinite(got[mask]).all()
    np.testing.assert_array_equal(ops.ivf_scan_q8(*targs).numpy(), got)


def test_q8_legacy_plain_keeps_nan_like_the_reference():
    from repro.core.quantize import QuantizedPostings as JQP
    from repro.core.quantize import ivf_scan_quantized as jax_quantized
    from repro_torch.kernels.ivf_scan_q8 import ivf_scan_q8_plain

    q8, scale, norm2, cents, _, cids, mask, q = q8_case(12, 8, 16, 3, 4,
                                                        seed=2)
    mask[1, 2] = True
    norm2[cids[1, 2], 5] = np.nan
    jargs = [jnp.asarray(a) for a in (q8, scale, norm2, cents, cids, mask, q)]
    want = np.asarray(jax_quantized(JQP(*jargs[:3]), *jargs[3:]))
    got = ivf_scan_q8_plain(*(torch.from_numpy(a) for a in
                              (q8, scale, norm2, cents, cids, mask, q)))
    assert np.isnan(want[1, 2, 5])
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper raises on tensors it cannot launch on; only ops
    dispatches CPU tensors to the plain versions."""
    from repro_torch.kernels.ivf_scan import ivf_scan_clustermajor_cuda
    from repro_torch.kernels.ivf_scan_q8 import ivf_scan_q8_cuda

    post, active, qsel, q = (torch.from_numpy(a) for a in
                             _cmajor_inputs(4, 4, 8, 2, 3, seed=1))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ivf_scan_clustermajor_cuda(post, active, qsel, q)
    args = [torch.from_numpy(a) for i, a in
            enumerate(q8_case(4, 4, 8, 2, 3, seed=1)) if i != 4]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ivf_scan_q8_cuda(*args)
