"""Port parity for the scaled-Gram K1 path: ``ops.gram.scaled_gram_plain``
against the JAX package's Pallas ``scaled_gram`` run in interpret mode,
``GramK1Backend`` against ``PallasK1Backend``, and the backend registry
against the reference's, all on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import tulip_tpu.kkt as jkkt
from tulip_tpu.kkt.pallas_chol import PallasK1Backend, scaled_gram
from tulip_tpu_torch import kkt
from tulip_tpu_torch.kkt import (DenseK1Backend, GramK1Backend,
                                 SmallK1Backend, make_backend)
from tulip_tpu_torch.ops import gram
from tulip_tpu_torch.ops.gram import scaled_gram_plain

torch.set_num_threads(1)


def gram_inputs(B, m, n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, m, n)).astype(np.float32)
    d = (10.0 ** rng.uniform(-3, 3, (B, n))).astype(np.float32)
    return A, d


@pytest.mark.parametrize("B,m,n", [(1, 300, 520), (3, 37, 200)],
                         ids=["300x520", "ragged-37x200"])
def test_scaled_gram_plain_matches_pallas_interpret(B, m, n):
    A, d = gram_inputs(B, m, n, seed=m)
    got = scaled_gram_plain(torch.from_numpy(A), torch.from_numpy(d))
    assert got.shape == (B, m, m) and got.dtype == torch.float32
    for b in range(B):
        want = np.asarray(scaled_gram(jnp.asarray(A[b]), jnp.asarray(d[b]),
                                      bm=128, bk=128, interpret=True))
        # f32 sums of n terms in two summation orders (tiles of 128 vs
        # one product): the measured gap is ~1e-7·max|K|.
        err = np.abs(got[b].numpy() - want).max()
        assert err <= 1e-5 * np.abs(want).max(), (b, err)


def test_scaled_gram_cpu_uses_plain_version():
    A, d = gram_inputs(2, 9, 14, seed=0)
    before = gram.KERNEL_LAUNCHES
    K = gram.scaled_gram(torch.from_numpy(A), torch.from_numpy(d))
    assert gram.KERNEL_LAUNCHES == before
    np.testing.assert_allclose(K.numpy(), np.einsum("bik,bk,bjk->bij",
                                                    A, d, A),
                               rtol=1e-5, atol=1e-4)


def kkt_inputs(m, n, seed):
    rng = np.random.default_rng(seed)
    return dict(
        A=rng.standard_normal((m, n)),
        theta_inv=10.0 ** rng.uniform(-2, 2, n),
        regP=np.full(n, 1e-6), regD=np.full(m, 1e-6),
        xi_p=rng.standard_normal(m), xi_d=rng.standard_normal(n))


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-10),
                                        ("float32", 1e-4)])
def test_gram_backend_matches_jax(dtype, rtol):
    """One update + solve of ``GramK1Backend`` against ``PallasK1Backend``
    (the dense XLA path off the TPU, with √d on both sides of K) on the
    same state."""
    x = kkt_inputs(24, 40, seed=1)
    jbe = PallasK1Backend()
    js = jbe.setup(jnp.asarray(x["A"], dtype=dtype))
    js, jok = jbe.update(js, *(jnp.asarray(x[k], dtype=dtype)
                               for k in ("theta_inv", "regP", "regD")))
    jdx, jdy = jbe.solve(js, jnp.asarray(x["xi_p"], dtype=dtype),
                         jnp.asarray(x["xi_d"], dtype=dtype))

    def t(v):
        return torch.as_tensor(np.asarray(v)[None],
                               dtype=getattr(torch, dtype))

    be = GramK1Backend()
    s = be.setup(t(x["A"]))
    s, ok = be.update(s, t(x["theta_inv"]), t(x["regP"]), t(x["regD"]))
    dx, dy = be.solve(s, t(x["xi_p"]), t(x["xi_d"]))
    assert bool(jok) and ok.tolist() == [True]
    assert dx.dtype == dy.dtype == getattr(torch, dtype)
    # f64: both sides factor the same K up to summation order. f32: the
    # port forms K with d on one side (as the TPU kernel does), the
    # reference with √d on both; K's conditioning turns that rounding
    # difference into ~1e-5 relative in the step.
    for got, want in ((dx, jdx), (dy, jdy)):
        want = np.asarray(want)
        err = np.abs(got[0].numpy() - want).max()
        assert err <= rtol * np.abs(want).max(), err


def test_gram_backend_f64_routes_to_dense_update(monkeypatch):
    calls = []
    monkeypatch.setattr(gram, "scaled_gram_plain",
                        lambda *a: calls.append(1) or None)
    x = kkt_inputs(6, 10, seed=2)
    A = torch.as_tensor(x["A"][None])
    args = [torch.as_tensor(x[k][None]) for k in ("theta_inv", "regP",
                                                  "regD")]
    s, ok = GramK1Backend().update(GramK1Backend().setup(A), *args)
    want, _ = DenseK1Backend().update(DenseK1Backend().setup(A), *args)
    assert calls == [] and ok.tolist() == [True]
    torch.testing.assert_close(s.L, want.L, rtol=0, atol=0)


def test_gram_backend_flags_a_failed_lane():
    """A lane whose K is not positive definite gets ok = False and the
    identity factor, the other lane is untouched."""
    x = kkt_inputs(8, 12, seed=3)
    A = torch.as_tensor(np.stack([x["A"], x["A"]]), dtype=torch.float32)
    be = GramK1Backend()
    theta = torch.as_tensor(np.stack([x["theta_inv"]] * 2),
                            dtype=torch.float32)
    regP = torch.full((2, 12), 1e-6)
    regD = torch.tensor([[1e-6] * 8, [-1e6] * 8])
    s, ok = be.update(be.setup(A), theta, regP, regD)
    assert ok.tolist() == [True, False]
    assert torch.equal(s.L[1], torch.eye(8))


@pytest.mark.parametrize("name", sorted(jkkt.available_backends()))
def test_registry_matches_reference(name):
    """Each name the reference registers builds the port backend of the
    same name, or raises NotImplementedError; never another backend."""
    if name in kkt.available_backends():
        be = make_backend(name, refinement_steps=1)
        assert be.name == name == jkkt.make_backend(name).name
        assert be.refinement_steps == 1
    else:
        assert name in kkt.UNPORTED
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_backend(name)


def test_registry_names():
    assert sorted(kkt.available_backends()) == [
        "banded", "car", "cg", "cr", "craig", "craigmr", "dense",
        "dense-ldl", "dense-mixed", "dense-pallas", "extended",
        "extended-dd", "lsmr", "lsqr", "minares", "minres", "minres-qlp",
        "pallas-small", "schur", "sparse", "sparse-ldl", "sparse-smw",
        "sqd-minres", "symmlq", "tricg"]
    assert SmallK1Backend.name == "pallas-small"
    assert make_backend().name == "dense"
    assert make_backend(None, "K2").name == "dense-ldl"
    with pytest.raises(ValueError):
        make_backend("dense", "K2")
    assert make_backend("sparse-ldl").name == "sparse-ldl"
    assert kkt.UNPORTED == {}
    assert make_backend("schur").name == "schur"
    assert make_backend("cg").name == "cg"


def tf32_round(x):
    """Round-to-nearest (ties away, as ``cvt.rna.tf32.f32``) of an f32
    tensor to TF32's 10 explicit mantissa bits, by integer masking."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x):
    """An f32 tensor with its last 13 mantissa bits dropped: what the
    tensor cores read of an operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_gram(A, d, passes):
    """The scaled-Gram product as the tensor cores form it, emulated: every
    operand an exact TF32 number, products summed in f32. ``passes == 3`` is
    the CUDA kernel's split (hi = x rounded to TF32, lo = x − hi cut to
    TF32 as the tensor cores cut an operand; lo·hi + hi·lo + hi·hi, small
    terms first), ``passes == 1`` plain TF32."""
    Ad = A * d.unsqueeze(-2)
    ahi, bhi = tf32_round(Ad), tf32_round(A)
    if passes == 1:
        return ahi @ bhi.transpose(-1, -2)
    alo, blo = tf32_cut(Ad - ahi), tf32_cut(A - bhi)
    bt, blt = bhi.transpose(-1, -2), blo.transpose(-1, -2)
    return (alo @ bt + ahi @ blt) + ahi @ bt


def test_three_pass_tf32_split_holds_the_bar_one_pass_does_not():
    """Why the kernel pays for three tensor-core products: on d spanning
    six decades the split is within 1e-5·max|K| of the plain f32 product
    (and as close to the f64 product as plain f32 is, within 4×), while a
    single TF32 pass misses the bar."""
    A, d = (torch.from_numpy(x) for x in gram_inputs(2, 300, 520, seed=9))
    want = scaled_gram_plain(A, d)
    exact = scaled_gram_plain(A.double(), d.double())
    scale = want.abs().amax(dim=(-1, -2))
    err3 = (tf32_gram(A, d, 3) - want).abs().amax(dim=(-1, -2)) / scale
    err1 = (tf32_gram(A, d, 1) - want).abs().amax(dim=(-1, -2)) / scale
    assert (err3 <= 1e-5).all(), err3
    assert (err1 > 1e-5).all(), err1
    far3 = (tf32_gram(A, d, 3).double() - exact).abs().amax(dim=(-1, -2))
    far = (want.double() - exact).abs().amax(dim=(-1, -2))
    assert (far3 <= 4 * far).all(), (far3, far)


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10,
                      -3.0 - 2.0 ** -10, 0.0, 1e-3])
    r = tf32_round(x)
    assert ((r.view(torch.int32) & 0x1FFF) == 0).all()
    assert r[:5].tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                              -3.0 - 2.0 ** -9, 0.0]
    assert abs(r[5].item() - 1e-3) <= 1e-3 * 2.0 ** -11


@pytest.mark.parametrize("backend", [
    GramK1Backend(refinement_steps=1),
    kkt.SmallK1Backend(refinement_steps=1),
    kkt.SmallK1Backend(refinement_steps=1, fused_solve=True)],
    ids=["dense-pallas", "pallas-small", "pallas-small-fused"])
def test_kernel_backends_take_bf16(backend):
    """The reference's kernel backends take bfloat16
    (tulip_tpu/kkt/pallas_chol.py:115,176; off the TPU its own bf16 path
    raises, so there is no reference to hold these to). On CPU tensors the
    port runs the plain versions in float32 on upcast copies and rounds:
    update + solve in bfloat16 stay within bfloat16's rounding of the
    same solve in float32."""
    rng = np.random.default_rng(4)
    B, m, n = 3, 10, 20
    host = [rng.standard_normal((B, m, n)), 10.0 ** rng.uniform(-1, 1, (B, n)),
            np.full((B, n), 1e-2), np.full((B, m), 1e-2),
            rng.standard_normal((B, m)), rng.standard_normal((B, n))]
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        A, th, rP, rD, xp, xd = (torch.as_tensor(a, dtype=dt) for a in host)
        st, ok = backend.update(backend.setup(A), th, rP, rD)
        assert ok.all().item() and st.L.dtype == dt
        out[dt] = backend.solve(st, xp, xd)
    for got, ref in zip(out[torch.bfloat16], out[torch.float32]):
        assert got.dtype == torch.bfloat16
        assert (got.float() - ref).abs().max() <= 3e-2 * ref.abs().max()

