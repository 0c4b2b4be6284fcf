"""The sequential encoder's device programs (K10a-d) and host helpers in the
port, against the JAX package's, exactly.

K10a ``predict_block`` (all 67 modes, luma sides 4-64, chroma sides 2-32,
8 and 10 bits), K10b ``predict_mip_all`` (every size class), K10c ``seq_tq``
(every MTS pair, DCT-2 at 64, the ISP shapes 1xN / Nx1 / 2xN / Nx2, QP
0/22/37/51 and the internal maximum 75, every stage mask) and K10d
``satd`` (every tile shape) take their plain versions here on the CPU; the
JAX functions are jitted. The host copies equal the JAX package's too:
``predict_mrl``, ``predict_isp`` and the ISP geometry, ``dep_quant_trellis``
/ ``dep_dequant`` against a running rate estimator, ``fwd_lfnst`` /
``inv_lfnst``, the CCLM host functions, the transform-skip quantiser and the
``RateEstimator``'s bits after the same bin sequence.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pmp_vvc_tpu.codec import estimator as jest
from pmp_vvc_tpu.codec.residual import grouped_scan as jgrouped_scan
from pmp_vvc_tpu.ops import cclm as jcclm
from pmp_vvc_tpu.ops import depquant as jdq
from pmp_vvc_tpu.ops import distortion as jdist
from pmp_vvc_tpu.ops import intra as jintra
from pmp_vvc_tpu.ops import lfnst as jlfnst
from pmp_vvc_tpu.ops import mip as jmip
from pmp_vvc_tpu.ops import quant as jquant
from pmp_vvc_tpu.ops import transforms as jtr
from pmp_vvc_tpu_torch.codec import estimator as port_est
from pmp_vvc_tpu_torch.codec.residual import grouped_scan
from pmp_vvc_tpu_torch.ops import cclm as tcclm
from pmp_vvc_tpu_torch.ops import depquant as tdq
from pmp_vvc_tpu_torch.ops import distortion as tdist
from pmp_vvc_tpu_torch.ops import intra as tintra
from pmp_vvc_tpu_torch.ops import lfnst as tlfnst
from pmp_vvc_tpu_torch.ops import mip as tmip
from pmp_vvc_tpu_torch.ops import quant as tquant
from pmp_vvc_tpu_torch.ops.transforms import DCT2, DCT8, DST7

torch.set_num_threads(2)
MODES = tuple(range(67))
# (w, h, luma, bit depth): every luma side at 10 bits in some block, the
# chroma sides of 2, and both bit depths
PREDICT_CASES = [(4, 4, True, 10), (8, 8, True, 8), (16, 16, True, 10), (32, 32, True, 10),
                 (64, 64, True, 10), (4, 16, True, 10), (16, 4, True, 8), (8, 32, True, 10),
                 (64, 16, True, 10), (2, 2, False, 10), (4, 2, False, 10), (2, 8, False, 8),
                 (8, 2, False, 10), (4, 4, False, 10), (16, 8, False, 10), (32, 32, False, 8)]
MIP_CASES = [(4, 4), (8, 4), (4, 16), (8, 8), (16, 16), (32, 8), (64, 64)]
TQ_SHAPES = [(4, 4), (8, 8), (32, 32), (8, 4), (16, 32), (64, 64), (64, 16), (1, 16),
             (16, 1), (4, 1), (2, 8), (8, 2), (2, 32)]
QPS = (0, 22, 37, 51, 75)
SATD_SIZES = [(16, 8), (8, 16), (8, 4), (4, 8), (8, 8), (4, 4), (2, 2), (64, 64), (32, 8),
              (2, 8), (8, 2), (4, 16)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _refs(rng, n, w, h, bd):
    tu = rng.randint(0, 1 << bd, (n, 2 * w + 3)).astype(np.int32)
    lu = rng.randint(0, 1 << bd, (n, 2 * h + 3)).astype(np.int32)
    lu[:, 0] = tu[:, 0]
    return tu, lu


@functools.cache
def _jit_predict(w, h, luma, bd):
    return jax.jit(lambda a, b, c, d: jintra.predict_block(
        a, b, c, d, w=w, h=h, modes=MODES, is_luma=luma, bit_depth=bd))


@pytest.mark.parametrize("w,h,luma,bd", PREDICT_CASES)
def test_predict_block_matches_jax(w, h, luma, bd):
    rng = np.random.RandomState(w * 7 + h + bd)
    tu, lu = _refs(rng, 2, w, h, bd)
    tf, lf = (np.asarray(a) for a in jintra.filter_reference_samples(jnp.asarray(tu),
                                                                      jnp.asarray(lu)))
    if not luma:
        tf, lf = tu, lu
    want = np.asarray(_jit_predict(w, h, luma, bd)(tu, lu, tf, lf))
    got = tintra.predict_block(_t(tu), _t(lu), _t(tf), _t(lf), w=w, h=h, modes=MODES,
                               is_luma=luma, bit_depth=bd)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)


def test_filter_reference_samples_matches_jax():
    rng = np.random.RandomState(3)
    tu, lu = _refs(rng, 3, 16, 8, 10)
    want = jintra.filter_reference_samples(jnp.asarray(tu), jnp.asarray(lu))
    got = tintra.filter_reference_samples(_t(tu), _t(lu))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("w,h", MIP_CASES)
def test_predict_mip_all_matches_jax(w, h):
    rng = np.random.RandomState(w + 3 * h)
    for bd in (8, 10):
        tu, lu = _refs(rng, 1, w, h, bd)
        want = np.asarray(jax.jit(functools.partial(
            jmip.predict_mip_all, w=w, h=h, bit_depth=bd))(tu[0], lu[0]))
        got = tmip.predict_mip_all(_t(tu[0]), _t(lu[0]), w=w, h=h, bit_depth=bd)
        assert got.shape == (2 * tmip.num_modes(w, h), h, w)
        assert np.array_equal(got.numpy(), want)


def _jax_stages(x, stages, kh, kv, qp, bd):
    """The JAX package's functions (each jitted there) in K10c's order."""
    h, w = x.shape[-2:]

    def run(v):
        outs = []
        if stages & tquant.FWD:
            v = jtr.forward_transform(v, kh, kv, bit_depth=bd)
            outs.append(v)
        if stages & tquant.QUANT:
            v = jquant.quantize(v, w=w, h=h, qp=qp, bit_depth=bd)
            outs.append(v)
        if stages & tquant.DEQUANT:
            v = jquant.dequantize(v, w=w, h=h, qp=qp, bit_depth=bd)
            outs.append(v)
        if stages & tquant.INV:
            v = jtr.inverse_transform(v, kh, kv, bit_depth=bd)
            outs.append(v)
        return jnp.stack(outs)
    return np.asarray(run(jnp.asarray(x)))


def _stage_input(rng, stages, n, h, w):
    first = stages & -stages
    lim = {tquant.FWD: 1023, tquant.QUANT: 30000, tquant.DEQUANT: 400,
           tquant.INV: 30000}[first]
    return rng.randint(-lim, lim + 1, (n, h, w)).astype(np.int32)


def _kind_pairs(w, h):
    kinds = (DCT2, DST7, DCT8)
    return [(kh, kv) for kh, kv in itertools.product(kinds, kinds)
            if (kh == DCT2 or 4 <= w <= 32) and (kv == DCT2 or 4 <= h <= 32)]


@pytest.mark.parametrize("w,h", TQ_SHAPES)
def test_seq_tq_round_trip_matches_jax(w, h):
    """The fused round trip of every kind pair at every QP point."""
    rng = np.random.RandomState(w * 5 + h)
    for (kh, kv), qp in itertools.product(_kind_pairs(w, h), QPS):
        x = _stage_input(rng, tquant.ROUND_TRIP, 2, h, w)
        got = tquant.seq_tq(_t(x), tquant.ROUND_TRIP, kind_h=kh, kind_v=kv, qp=qp)
        want = _jax_stages(x, tquant.ROUND_TRIP, kh, kv, qp, 10)
        assert got.shape == (4, 2, h, w)
        assert np.array_equal(got.numpy(), want), (kh, kv, qp)


@pytest.mark.parametrize("stages", range(1, 16))
def test_seq_tq_stage_masks_match_jax(stages):
    """Every stage mask, on 2-D and 1-D TUs, at 8 and 10 bits; the one-stage
    wrappers are the masks 1, 2, 4 and 8."""
    rng = np.random.RandomState(stages)
    for (w, h, kh, kv), bd in itertools.product(
            ((8, 16, DST7, DCT8), (32, 4, DCT2, DST7), (1, 16, DCT2, DST7), (64, 64, DCT2, DCT2)),
            (8, 10)):
        x = _stage_input(rng, stages, 1, h, w)
        got = tquant.seq_tq(_t(x), stages, kind_h=kh, kind_v=kv, qp=27, bit_depth=bd)
        assert np.array_equal(got.numpy(), _jax_stages(x, stages, kh, kv, 27, bd))
    one = {tquant.FWD: lambda v: tquant.forward_transform(v, DST7, DCT8),
           tquant.QUANT: lambda v: tquant.quantize(v, w=8, h=16, qp=27),
           tquant.DEQUANT: lambda v: tquant.dequantize(v, w=8, h=16, qp=27),
           tquant.INV: lambda v: tquant.inverse_transform(v, DST7, DCT8)}
    if stages in one:
        x = _stage_input(rng, stages, 1, 16, 8)
        assert np.array_equal(one[stages](_t(x)).numpy(),
                              _jax_stages(x, stages, DST7, DCT8, 27, 10)[0])


@pytest.mark.parametrize("w,h", SATD_SIZES)
def test_satd_matches_jax(w, h):
    rng = np.random.RandomState(w + h)
    org = rng.randint(0, 1024, (h, w)).astype(np.int32)
    cur = rng.randint(0, 1024, (1, 9, h, w)).astype(np.int32)
    cur[0, 0] = org                                   # a zero SATD
    want = np.asarray(jax.jit(jdist.satd)(jnp.asarray(org)[None, None], jnp.asarray(cur)))
    got = tdist.satd(_t(org)[None, None], _t(cur))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    assert tdist._tile_shape(w, h) == jdist._tile_shape(w, h)


def test_transform_helpers_match_jax():
    from pmp_vvc_tpu_torch.ops import transforms as ttr
    for kind, n in itertools.product((DCT2, DST7, DCT8), (4, 8, 16, 32, 64)):
        assert ttr.nonzero_out_size(kind, n) == jtr.nonzero_out_size(kind, n)
    for w, h, bd in itertools.product((2, 4, 64), (4, 32), (8, 10)):
        assert ttr.transform_shift_fwd(w, h, bd) == jtr.transform_shift_fwd(w, h, bd)


def test_transform_skip_quantiser_matches_jax():
    rng = np.random.RandomState(11)
    r = rng.randint(-1023, 1024, (8, 8))
    for qp in (4, 22, 37, 51, 63):
        qpt = tquant.ts_qp(qp, 2)
        lev = tquant.quantize_ts(r, qpt)
        assert np.array_equal(lev, jquant.quantize_ts(r, qpt))
        assert np.array_equal(tquant.dequantize_ts(lev, qpt), jquant.dequantize_ts(lev, qpt))


@pytest.mark.parametrize("w,h", [(8, 8), (16, 4), (4, 16), (32, 32)])
def test_predict_mrl_matches_jax(w, h):
    rng = np.random.RandomState(w + h)
    for mri, mode in itertools.product((1, 2), (1, 2, 18, 30, 50, 66, 40, 10)):
        top = rng.randint(0, 1024, 2 * w + 1 + mri + 4)
        left = rng.randint(0, 1024, 2 * h + 1 + mri + 4)
        kw = dict(w=w, h=h, mode=mode, mri=mri, bit_depth=10)
        assert np.array_equal(tintra.predict_mrl(top, left, **kw),
                              jintra.predict_mrl(top, left, **kw))
        vals = rng.randint(0, 1024, 2 * (w + h) + 1)
        avail = rng.rand(vals.size) < 0.6
        assert np.array_equal(tintra.substitute_line(vals, avail),
                              jintra.substitute_line(vals, avail))


@pytest.mark.parametrize("cu_w,cu_h", [(8, 8), (4, 16), (16, 4), (32, 16), (8, 64), (64, 64)])
def test_predict_isp_matches_jax(cu_w, cu_h):
    rng = np.random.RandomState(cu_w * 3 + cu_h)
    assert tintra.can_use_isp(cu_w, cu_h) == jintra.can_use_isp(cu_w, cu_h)
    for isp in (1, 2):
        assert tintra.can_use_lfnst_with_isp(cu_w, cu_h, isp) == \
            jintra.can_use_lfnst_with_isp(cu_w, cu_h, isp)
        div = isp == 1
        assert tintra.isp_split_dim(cu_w, cu_h, div) == jintra.isp_split_dim(cu_w, cu_h, div)
        sub = tintra.isp_split_dim(cu_w, cu_h, div)
        pw, ph = (cu_w, sub) if div else (max(sub, 4), cu_h)
        for mode in (0, 1, 2, 18, 34, 50, 66, 7, 60):
            top = rng.randint(0, 1024, 2 * pw + 3 + cu_w)
            left = rng.randint(0, 1024, 2 * ph + 3 + cu_h)
            kw = dict(cu_w=cu_w, cu_h=cu_h, pw=pw, ph=ph, mode=mode, bit_depth=10)
            assert np.array_equal(tintra.predict_isp(top, left, **kw),
                                  jintra.predict_isp(top, left, **kw))


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 4), (16, 16), (32, 8), (1, 16), (64, 64)])
def test_dep_quant_matches_jax(w, h):
    """The trellis against a running rate estimator advanced by the same
    bins, and the dependent dequantiser."""
    rng = np.random.RandomState(w * 11 + h)
    est_j = jest.RateEstimator.standard_init(32, 2)
    est_t = port_est.RateEstimator.standard_init(32, 2)
    for k in range(40):
        b, c = int(rng.randint(2)), int(rng.randint(0, 300))
        est_j.encode_bin(b, c)
        est_t.encode_bin(b, c)
    assert np.array_equal(grouped_scan(w, h), jgrouped_scan(w, h))
    scan = grouped_scan(w, h)[:, 0]
    for qp, is_luma in ((22, True), (37, False), (51, True)):
        coef = (rng.randn(h, w) * rng.choice([20, 300, 3000])).astype(np.int32)
        coef[32:, :] = 0
        coef[:, 32:] = 0
        kw = dict(w=w, h=h, qp=qp, bit_depth=10)
        lev_t = tdq.dep_quant_trellis(coef, scan, lam=40.0, is_luma=is_luma, est=est_t, **kw)
        lev_j = jdq.dep_quant_trellis(coef, scan, lam=40.0, is_luma=is_luma, est=est_j, **kw)
        assert np.array_equal(lev_t, lev_j)
        assert np.array_equal(tdq.dep_dequant(lev_t, scan, **kw),
                              jdq.dep_dequant(lev_j, scan, **kw))
        assert np.array_equal(tdq.dep_quant_greedy(coef, scan, **kw),
                              jdq.dep_quant_greedy(coef, scan, **kw))


@pytest.mark.parametrize("w,h", [(4, 4), (8, 8), (16, 8), (4, 16), (32, 32)])
def test_lfnst_matches_jax(w, h):
    rng = np.random.RandomState(w + 5 * h)
    for mode, idx in itertools.product((0, 1, 2, 18, 34, 50, 66, 10, 60), (1, 2)):
        c = rng.randint(-3000, 3000, (h, w))
        f = tlfnst.fwd_lfnst(c, mode, idx, w, h)
        assert np.array_equal(f, jlfnst.fwd_lfnst(c, mode, idx, w, h))
        assert np.array_equal(tlfnst.inv_lfnst(f, mode, idx, w, h),
                              jlfnst.inv_lfnst(f, mode, idx, w, h))


def test_cclm_host_functions_match_jax():
    rng = np.random.RandomState(21)
    rec = rng.randint(0, 1024, (64, 64))
    for (xc, yc, wc, hc), la, aa in itertools.product(
            ((8, 8, 4, 4), (4, 12, 8, 2), (16, 4, 2, 8)), (False, True), (False, True)):
        got = tcclm.downsample_luma(rec, xc, yc, wc, hc, la, aa, 128)
        want = jcclm.downsample_luma(rec, xc, yc, wc, hc, la, aa, 128)
        for g, w in zip(got, want):
            assert (g is None and w is None) or np.array_equal(g, w)
        interior, dsa, dsl = want
        top = rng.randint(0, 1024, 2 * wc + 3)
        left = rng.randint(0, 1024, 2 * hc + 3)
        a, b, sh = tcclm.lm_parameters(dsa, dsl, top, left, wc, hc, aa, la, 10)
        assert (a, b, sh) == jcclm.lm_parameters(dsa, dsl, top, left, wc, hc, aa, la, 10)
        assert np.array_equal(tcclm.cclm_pred(interior, a, b, sh, 10),
                              jcclm.cclm_pred(interior, a, b, sh, 10))
        for n in (wc, wc + 2):
            ab = tcclm.downsample_above(rec, xc, yc, n, la, 128)
            assert np.array_equal(ab, jcclm.downsample_above(rec, xc, yc, n, la, 128))
            assert tcclm.mdlm_parameters(True, ab, top, n, 10) == \
                jcclm.mdlm_parameters(True, ab, top, n, 10)
        for n in (hc, hc + 2):
            lf = tcclm.downsample_left(rec, xc, yc, n)
            assert np.array_equal(lf, jcclm.downsample_left(rec, xc, yc, n))
            assert tcclm.mdlm_parameters(False, lf, left, n, 10) == \
                jcclm.mdlm_parameters(False, lf, left, n, 10)


def test_rate_estimator_matches_jax():
    """The same bins (context, bypass, remainder, terminate) give the same
    fractional bits and bin costs, through a clone too."""
    rng = np.random.RandomState(4)
    ests = [m.RateEstimator.standard_init(27, 2) for m in (jest, port_est)]
    for k in range(2000):
        op = rng.randint(5)
        for e in ests:
            if op == 0:
                e.encode_bin(k & 1, (k * 37) % 300)
            elif op == 1:
                e.encode_bin_ep(k & 1)
            elif op == 2:
                e.encode_bins_ep(k % 8, 3)
            elif op == 3:
                e.encode_rem_abs_ep(k % 50, k % 4, 5, 15)
            else:
                e.encode_bin((k >> 1) & 1, (k * 13) % 300)
        if k % 500 == 0:
            ests = [e.clone() for e in ests]
    assert ests[0].frac == ests[1].frac and ests[0].bits == ests[1].bits
    assert [ests[0].bin_bits(b, c) for b in (0, 1) for c in range(0, 300, 7)] == \
        [ests[1].bin_bits(b, c) for b in (0, 1) for c in range(0, 300, 7)]
