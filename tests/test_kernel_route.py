"""Kernel route by platform, the in-kernel counter hash, padding off the
block grid, float32 precision of the step's matrix products, the compile
cache helper, and chip_smoke's device check."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instruct_jax import cache
from instruct_jax.config import ModelSpec, PriorFamily, Priors
from instruct_jax.data.synthetic import synthetic_panel, synthetic_tetra_panel
from instruct_jax.kernels import fused_step as fs
from instruct_jax.kernels import pallas_route
from instruct_jax.mcmc import step as st
from instruct_jax.mcmc import updates as up
from instruct_jax.mcmc.state import init_state, masked_z_counts
from instruct_jax.model import likelihood as lk


# --- route --------------------------------------------------------------

@pytest.mark.parametrize("use_pallas,platform,want", [
    (None, "cpu", None), (None, "gpu", "triton"), (False, "gpu", None),
    (True, "gpu", "triton"), (False, "cpu", None)])
def test_route_by_platform(use_pallas, platform, want):
    assert pallas_route(use_pallas, platform) == want


def test_use_pallas_true_without_route_raises():
    with pytest.raises(ValueError, match="no Pallas kernel route"):
        pallas_route(True, "cpu")
    data = synthetic_panel(n_indv=6, n_loci=9, n_pops=2, seed=1).data
    with pytest.raises(ValueError, match="use_pallas=True"):
        st.build_step_parts(ModelSpec(mode=2, n_pops=2, use_pallas=True),
                            data)


def test_cpu_default_takes_xla_path():
    data = synthetic_panel(n_indv=6, n_loci=9, n_pops=2, seed=1).data
    assert not st._use_fused(ModelSpec(mode=2, n_pops=2), data)


# --- counter hash -------------------------------------------------------

def test_site_uniforms_deterministic_and_seeded():
    a = fs.site_uniforms(jnp.asarray([1, 2], jnp.int32), 40, 70)
    b = fs.site_uniforms(jnp.asarray([1, 2], jnp.int32), 40, 70)
    c = fs.site_uniforms(jnp.asarray([1, 3], jnp.int32), 40, 70)
    assert a.shape == (40, 140)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.mean(np.asarray(a) == np.asarray(c)) < 1e-3


def test_site_uniforms_moments():
    """Mean, variance, histogram and neighbour correlations (along loci,
    across individuals, between the two copies) of one seed's plane."""
    u = np.asarray(fs.site_uniforms(jnp.asarray([7, -9], jnp.int32),
                                    300, 500), np.float64)   # [300, 1000]
    m = u.size
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / m)
    assert abs(u.var() - 1 / 12) < 0.002
    hist = np.histogram(u, bins=20, range=(0, 1))[0]
    chi2 = ((hist - m / 20) ** 2 / (m / 20)).sum()
    assert chi2 < 50                    # 19 dof: p ~ 1e-4
    c0, c1 = u[:, :500], u[:, 500:]
    for x, y in ((c0[:, 1:], c0[:, :-1]), (c0[1:], c0[:-1]), (c0, c1)):
        assert abs(np.corrcoef(x.ravel(), y.ravel())[0, 1]) < 0.01


def test_mix32_bijective_on_sample():
    x = jnp.arange(200_000, dtype=jnp.uint32) * jnp.uint32(2654435761)
    assert np.unique(np.asarray(fs.mix32(x))).size == x.size


def test_seed_pair_folds_words():
    np.testing.assert_array_equal(np.asarray(fs._seed_pair(5)), [5, 0])
    np.testing.assert_array_equal(
        np.asarray(fs._seed_pair(jnp.asarray([1, 2, 4, 8], jnp.int32))),
        [1 ^ 4, 2 ^ 8])


# --- padding off the block grid -----------------------------------------

@pytest.mark.parametrize("n,l", [(5, 7), (37, 45)])
def test_padding_off_block_multiples(n, l):
    """Shapes off every block multiple: the masked loads and stores give
    the reference z, counts and log-ratio, and nothing lands outside."""
    panel = synthetic_panel(n_indv=n, n_loci=l, n_pops=3, missing_rate=0.1,
                            seed=n)
    data = panel.data
    rng = np.random.default_rng(n)
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(3, l)), jnp.float32)
    q = jnp.asarray(rng.dirichlet(np.ones(3), size=n), jnp.float32)
    u = jax.random.uniform(jax.random.key(n), data.geno.shape,
                           minval=1e-6, maxval=1 - 1e-6)
    wg = jnp.exp2(-jnp.asarray(rng.integers(0, 5, (n, 2)), jnp.float32))
    z, qq, diff, cnt = fs.zq_gendiff_pass(
        0, q, freq, data.geno, data.site_valid, data.hom,
        jnp.zeros_like(data.geno), wg, structure=True, interpret=True, u=u,
        bits2=data.bits2, block=(16, 8, 16))
    assert z.shape == (n, 2 * l) and qq.shape == (n, 3)
    terms = [q[:, kk][:, None] * pk
             for kk, pk in enumerate(lk.per_pop_copy_probs(freq, data))]
    cum = np.cumsum(np.stack([np.asarray(t) for t in terms]), axis=0)
    z_ref = (np.asarray(u)[None] * cum[-1][None] > cum[:-1]).sum(0)
    np.testing.assert_array_equal(np.asarray(z), z_ref)
    np.testing.assert_array_equal(np.asarray(qq),
                                  np.asarray(masked_z_counts(z, data, 3)))
    np.testing.assert_array_equal(
        np.asarray(cnt),
        np.asarray(up.allele_pop_counts(ModelSpec(mode=2, n_pops=3), data,
                                        z, None)))
    spec = ModelSpec(mode=2, n_pops=3)
    gen = (1 - jnp.log2(wg)).astype(jnp.int32)
    r = jnp.zeros(3)
    want = (lk.per_indv_loglik(spec, data, freq, z, q, gen[:, 1], r)
            - lk.per_indv_loglik(spec, data, freq, z, q, gen[:, 0], r))
    np.testing.assert_allclose(np.asarray(diff), np.asarray(want),
                               rtol=2e-4, atol=2e-3)


@pytest.mark.gpu
def test_compiled_kernel_matches_interpret(gpu):
    """The pass compiled for the card gives the interpret-mode result."""
    data = synthetic_panel(n_indv=70, n_loci=300, n_pops=3, seed=2).data
    rng = np.random.default_rng(2)
    freq = jnp.asarray(rng.dirichlet(np.ones(2), size=(3, 300)), jnp.float32)
    q = jnp.asarray(rng.dirichlet(np.ones(3), size=70), jnp.float32)
    wg = jnp.full((70, 2), 0.5, jnp.float32)
    args = (jnp.asarray([3, 4], jnp.int32), q, freq, data.geno,
            data.site_valid, data.hom, jnp.zeros_like(data.geno), wg)
    a = fs.zq_gendiff_pass(*args, structure=True, bits2=data.bits2)
    b = fs.zq_gendiff_pass(*args, structure=True, bits2=data.bits2,
                           interpret=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=1e-5,
                                   atol=1e-4)


# --- float32 precision of the step's matrix products ---------------------

def _dot_precisions(jaxpr):
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    out += _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    out += _dot_precisions(sub)
    return out


_CASES = {
    "mode0": ModelSpec(mode=0, n_pops=2),
    "mode1": ModelSpec(mode=1, n_pops=2),
    "mode2": ModelSpec(mode=2, n_pops=2, s_subsweeps=2),
    "mode2_marg": ModelSpec(mode=2, n_pops=2, marginalize_g=True),
    "mode3": ModelSpec(mode=3, n_pops=2),
    "mode4": ModelSpec(mode=4, n_pops=2),
    "mode5_dpm": ModelSpec(mode=5, n_pops=2,
                           priors=Priors(family=PriorFamily.DPM)),
    "tetra": ModelSpec(mode=2, ploid=4, n_pops=2),
}


@pytest.mark.parametrize("case", sorted(_CASES) + ["mode2_fused"])
def test_step_matmuls_pin_highest(case):
    """Every dot_general of the step (and its log-likelihood pass) asks
    for HIGHEST precision: on the GPU a float32 product left at the
    default may run in TF32, which moves MH ratios of 10^3-10^4 nats."""
    spec = _CASES.get(case, _CASES["mode2"])
    if spec.ploid == 4:
        data = synthetic_tetra_panel(n_indv=8, n_loci=10, n_pops=2,
                                     seed=1).data
        from instruct_jax.tetra.engine import init_tetra_state
        state = init_tetra_state(jax.random.key(0), spec, data)
    else:
        data = synthetic_panel(n_indv=8, n_loci=12, n_pops=2, seed=1).data
        state = init_state(jax.random.key(0), spec, data)
    if case == "mode2_fused":
        core, add_ll = st._build_fused_parts(spec, data)
    else:
        core, add_ll = st.build_step_parts(spec, data)
    jaxpr = jax.make_jaxpr(lambda s, k: add_ll(core(s, k)))(
        state, jax.random.key(1))
    precs = _dot_precisions(jaxpr.jaxpr)
    hi = jax.lax.Precision.HIGHEST
    assert all(p is not None and all(x == hi for x in p) for p in precs), \
        precs


# --- compile cache ----------------------------------------------------------

@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    old = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in old.items():
        jax.config.update(k, v)


def test_cache_helper_defaults_to_checkout(monkeypatch, restore_cache_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compile_cache()
    assert path == os.path.join(cache.CHECKOUT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isfile(os.path.join(cache.CHECKOUT, "instruct_jax",
                                       "cache.py"))


def test_cache_helper_leaves_env_dir_to_jax(monkeypatch, tmp_path,
                                            restore_cache_config):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


# --- chip_smoke ---------------------------------------------------------------

def test_chip_smoke_refuses_cpu(capsys):
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu("cpu")
    assert "no GPU" in str(exc.value)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok"' not in capsys.readouterr().out
