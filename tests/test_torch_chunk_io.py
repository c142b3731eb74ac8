"""A MoEvA chunk's prepare and decode (kernel K13's plain versions,
``attacks/moeva/chunk_io.py``) against the JAX package on the CPU, in float64.

K13a's plain version (``chunk_prepare_plain``: the gene bounds, the
normalised states, the initial population and the normalisation memory)
against JAX's ``codec.genetic_bounds``, ``codec.minmax_normalize``,
``initialisation.tile_init`` and ``lp_ratio_init`` (the same ball draws fed
to both) and ``survival.NormState.init``; K13b's (``chunk_decode_plain``: the
returned columns, population then archive, and their decode) against JAX's
concatenation and ``codec.genetic_to_ml``, on LCLD, augmented LCLD, botnet
and ``lcld_spec``. Bounds, normalisation, tiles and decode are equal bit for
bit (gathers, one subtraction and one division an entry); the moved rows of
``lp_ratio`` within 1e-12 relative and absolute (XLA's ball norm sums in
another order than the left-to-right sum). The wrappers refuse CPU tensors
before anything is built. K13 itself is held against these plain versions
on the card by ``chip_smoke.py`` phase 20.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moeva2_ijcai22_replication_tpu import domains as jdomains
from moeva2_ijcai22_replication_tpu.attacks.moeva import initialisation as jinit
from moeva2_ijcai22_replication_tpu.attacks.moeva.survival import NormState as JNormState
from moeva2_ijcai22_replication_tpu.core import codec as jcodec
from moeva2_ijcai22_replication_tpu.domains.botnet import BotnetConstraints as JBotnet
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldAugmentedConstraints as JLcldAug
from moeva2_ijcai22_replication_tpu.domains.lcld import LcldConstraints as JLcld
from moeva2_ijcai22_replication_tpu_torch import kernels
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.chunk_io import (
    InitSpec, chunk_decode, chunk_decode_plain, chunk_prepare, chunk_prepare_plain, make_chunk_tables,
)
from moeva2_ijcai22_replication_tpu_torch.attacks.moeva.initialisation import ball_draw_shape, n_perturbed
from moeva2_ijcai22_replication_tpu_torch.core import codec as codec_lib
from moeva2_ijcai22_replication_tpu_torch.problems import (
    synthetic_botnet_problem, synthetic_lcld_augmented_problem, synthetic_lcld_problem, synthetic_lcld_spec_problem,
)

torch.set_num_threads(1)

#: domain -> (the port's synthetic problem, the JAX set over the same files, the files' suffix)
DOMAINS = {
    "lcld": (synthetic_lcld_problem, JLcld, ""),
    "lcld_augmented": (synthetic_lcld_augmented_problem, JLcldAug, "_augmented"),
    "botnet": (synthetic_botnet_problem, JBotnet, ""),
    "lcld_spec": (synthetic_lcld_spec_problem, jdomains.get_constraints_class("lcld_spec"), ""),
}
STATES = 5
N_POP = 20
#: (init, norm): the tile and lp_ratio's two balls
INITS = [("tile", 2), ("lp_ratio", 2), ("lp_ratio", np.inf)]


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    out = {}
    for name, (problem, jcls, suffix) in DOMAINS.items():
        tmp = tmp_path_factory.mktemp(name)
        cons, _, _, x = problem(str(tmp), STATES)
        jcons = jcls(str(tmp / f"features{suffix}.csv"), str(tmp / f"constraints{suffix}.csv"))
        xl, xu = (np.array(np.broadcast_to(np.asarray(a, np.float64), x.shape)) for a in cons.get_feature_min_max(x))
        out[name] = dict(cons=cons, jc=jcodec.make_codec(jcons.schema), x=x, xl=xl, xu=xu,
                         tables=make_chunk_tables(codec_lib.make_codec(cons.schema), "cpu"))
    return out


def _t(a):
    return torch.as_tensor(np.array(a))


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True) and np.array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("init,norm", INITS)
@pytest.mark.parametrize("name", list(DOMAINS))
def test_prepare_plain_matches_jax(domains, name, init, norm):
    dom = domains[name]
    x, xl, xu, jc, tables = dom["x"], dom["xl"], dom["xu"], dom["jc"], dom["tables"]
    codec = tables.codec
    key = jax.random.PRNGKey(11)
    ratio, eps = 0.4, 0.2
    n_pert = n_perturbed(N_POP, ratio) if init == "lp_ratio" else 0
    ball = None
    if n_pert:
        shape = ball_draw_shape(norm, (STATES, n_pert, codec.gen_length))
        ball = _t(jax.random.normal(key, shape) if norm == 2
                  else jax.random.uniform(key, shape, minval=-1.0, maxval=1.0))
    got = chunk_prepare_plain(tables, _t(x), _t(xl), _t(xu), InitSpec(N_POP, init == "lp_ratio", ball, eps, ratio, norm))
    jxl, jxu = jcodec.genetic_bounds(jc, jnp.asarray(xl), jnp.asarray(xu))
    _exact(got.xl_gen.numpy(), jxl)
    _exact(got.xu_gen.numpy(), jxu)
    _exact(got.x_mm.numpy(), jcodec.minmax_normalize(jnp.asarray(x), jnp.asarray(xl), jnp.asarray(xu)))
    if init == "tile":
        _exact(got.pop_x.numpy(), jinit.tile_init(jc, jnp.asarray(x), N_POP))
    else:
        want = np.asarray(jinit.lp_ratio_init(key, jc, jnp.asarray(x), N_POP, jxl, jxu, eps=eps, ratio=ratio,
                                              norm=norm))
        _exact(got.pop_x.numpy()[:, : N_POP - n_pert], want[:, : N_POP - n_pert])
        np.testing.assert_allclose(got.pop_x.numpy(), want, rtol=1e-12, atol=1e-12)
        assert (want[:, -n_pert:] != want[:, :1]).any()
    j0 = JNormState.init(3, jnp.float64)
    for k, g in zip(("ideal", "worst", "extreme"), got.norm_state):
        _exact(g.numpy(), np.broadcast_to(np.asarray(getattr(j0, k)), g.shape))
    # without a population, the same bounds and nothing else
    bare = chunk_prepare_plain(tables, _t(x), _t(xl), _t(xu))
    assert bare.pop_x is None and bare.norm_state is None
    _exact(bare.x_mm.numpy(), got.x_mm.numpy())


@pytest.mark.parametrize("archive", [0, 4])
@pytest.mark.parametrize("name", list(DOMAINS))
def test_decode_plain_matches_jax(domains, name, archive):
    dom = domains[name]
    x, jc, tables = dom["x"], dom["jc"], dom["tables"]
    codec = tables.codec
    rng = np.random.default_rng(len(name) + archive)
    xl_gen, xu_gen = (t.numpy() for t in codec_lib.genetic_bounds(codec, _t(dom["xl"]), _t(dom["xu"])))
    cols = N_POP + archive
    gen = xl_gen[:, None] + rng.random((STATES, cols, codec.gen_length)) * (xu_gen - xl_gen)[:, None]
    # categorical genes on and between their slots, .5 among them (rounded half to even)
    cat = np.asarray(codec.int_mask_gen) & (np.arange(codec.gen_length) >= codec.n_non_ohe)
    gen[..., cat] = np.round(gen[..., cat] * 2) / 2
    f = rng.normal(size=(STATES, cols, 3))
    got = chunk_decode_plain(tables, _t(gen[:, :N_POP]), _t(gen[:, N_POP:]), _t(f[:, :N_POP]), _t(f[:, N_POP:]),
                             _t(x))
    _exact(got[0].numpy(), gen)
    _exact(got[1].numpy(), f)
    _exact(got[2].numpy(), jcodec.genetic_to_ml(jc, jnp.asarray(gen), jnp.asarray(x)[:, None, :]))


def test_wrappers_refuse_cpu_tensors(domains):
    dom = domains["lcld"]
    tables = dom["tables"]
    x, xl, xu = (torch.as_tensor(dom[k], dtype=torch.float32) for k in ("x", "xl", "xu"))
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.chunk_prepare(tables, x, xl, xu, InitSpec(N_POP))
    pop = torch.zeros((STATES, N_POP, tables.codec.gen_length))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.chunk_decode(tables, pop, pop[:, :0], torch.zeros((STATES, N_POP, 3)), torch.zeros((STATES, 0, 3)), x)
    assert kernels.launch_counts() == before
    # on CPU tensors the dispatchers run the plain versions
    assert chunk_prepare(tables, x, xl, xu, InitSpec(N_POP)).pop_x.shape == pop.shape
    assert chunk_decode(tables, pop, pop[:, :0], torch.zeros((STATES, N_POP, 3)), torch.zeros((STATES, 0, 3)),
                        x)[2].shape == (STATES, N_POP, x.shape[1])
    assert kernels.launch_counts() == before
