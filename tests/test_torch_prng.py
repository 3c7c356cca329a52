"""The port's counter-keyed PRNG (``repro_torch.prng``) against
``jax.random`` under JAX's defaults: the keys and the uniform draws equal
bit for bit, for the fault plan's (5,) draws and for (n_qblocks, qblock)
blocks of the shape the q4 wire's stochastic rounding draws, from the
numpy twin and from the torch-op twin the q4 codec uses (on the CPU
here; ``chip_smoke.py`` holds it to the numpy twin on the card).  The
key splits equal ``jax.random.split`` bit for bit; so do the normal
draws of the model inits (numpy and torch-op twins) and the f32 log1p
inside them, which is XLA's (``jax.jit(jnp.log1p)``) on a dense sweep of
[-1, 0]."""
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch import prng  # noqa: E402

SEEDS = [0, 1, 7, 7_000_021, 2 ** 31 - 1]


def _jax_key(seed, cid, n):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 cid), n)


def _port_key(seed, cid, n):
    return prng.fold_in(prng.fold_in(prng.prng_key(seed), cid), n)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal(seed):
    np.testing.assert_array_equal(prng.prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    for cid, n in ((0, 0), (3, 1), (15, 250), (2 ** 20, 2 ** 31)):
        np.testing.assert_array_equal(_port_key(seed, cid, n),
                                      np.asarray(_jax_key(seed, cid, n)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fault_draws_bitwise(seed):
    """The (5,) draw of every (client, counter) the fault plan makes."""
    draw = jax.jit(lambda s, c, n: jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(s), c), n),
        (5,), jnp.float32))
    rng = np.random.default_rng(seed % 1000)
    for cid, n in zip(rng.integers(0, 64, 40), rng.integers(0, 500, 40)):
        want = np.asarray(draw(seed, int(cid), int(n)))
        got = prng.uniform(_port_key(seed, cid, n), (5,))
        assert got.dtype == np.float32 and got.shape == (5,)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


@pytest.mark.parametrize("shape", [(37, 64), (9, 512), (1,), (4099,)])
def test_block_draws_bitwise(shape):
    for seed, cid, n in ((0, 0, 0), (7, 5, 3), (123, 2, 99)):
        want = np.asarray(jax.random.uniform(_jax_key(seed, cid, n), shape,
                                             jnp.float32))
        got = prng.uniform(_port_key(seed, cid, n), shape)
        assert got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("shape", [(4209, 512), (37, 64), (1,), (4099,),
                                   (3, 5, 7)])
def test_torch_draws_bitwise(shape):
    """``uniform_torch`` equals the numpy twin and ``jax.random.uniform``
    bit for bit; (4209, 512) is the paper CNN's q4 draw per upload."""
    import torch
    keys = ((0, 0, 0), (7, 5, 3), (2 ** 31 - 1, 15, 250))
    for seed, cid, n in keys[:1] if shape == (4209, 512) else keys:
        key = _port_key(seed, cid, n)
        got = prng.uniform_torch(key, shape, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        want = np.asarray(jax.random.uniform(_jax_key(seed, cid, n), shape,
                                             jnp.float32))
        bits = got.numpy().view(np.uint32)
        np.testing.assert_array_equal(bits, want.view(np.uint32))
        np.testing.assert_array_equal(
            bits, prng.uniform(key, shape).view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bitwise(seed):
    for n in (1, 2, 5, 28, 1000):
        np.testing.assert_array_equal(
            prng.split(prng.prng_key(seed), n),
            np.asarray(jax.random.split(jax.random.PRNGKey(seed), n)))
    # a split of a split, as the transformer's init walks its keys
    k = prng.split(prng.split(prng.prng_key(seed), 5)[1], 28)[27]
    jk = jax.random.split(jax.random.split(jax.random.PRNGKey(seed), 5)[1],
                          28)[27]
    np.testing.assert_array_equal(k, np.asarray(jk))


@pytest.mark.parametrize("twin", ["numpy", "torch"])
def test_log1p_bitwise(twin):
    """XLA's f32 log1p (the normal draws' ``w = -log1p(-x*x)``) against
    ``jax.jit(jnp.log1p)`` on 2^20 evenly spaced lanes of [-1, 0] and on
    ``-u*u`` for 2^18 uniform u: every lane bitwise, both branches (the
    rational form below sqrt(2) - 1, XLA's log above) and the ends
    (-1 -> -inf, 0 -> 0)."""
    import torch
    xs = np.concatenate([
        np.linspace(-1.0, 0.0, 1 << 20, dtype=np.float32),
        -np.square(np.random.default_rng(0).uniform(-1, 1, 1 << 18)
                   .astype(np.float32))])
    want = np.asarray(jax.jit(jnp.log1p)(xs))
    if twin == "numpy":
        got = prng._log1p(xs, np, prng._np_to, prng._np_view)
    else:
        got = prng._log1p(torch.from_numpy(xs), torch, prng._torch_to,
                          prng._torch_view).numpy()
    assert got.dtype == np.float32
    assert got[0] == -np.inf and got[(1 << 20) - 1] == 0.0
    small = np.abs(xs) < np.float32(0.41421356)
    assert 0.3 < small.mean() < 0.7
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("twin", ["numpy", "torch"])
@pytest.mark.parametrize("shape", [(1,), (4099,), (256, 512), (3, 5, 7)])
def test_normal_within_4_ulp(twin, shape):
    """``prng.normal`` / ``normal_torch`` (CPU) against
    ``jax.random.normal``: every lane bitwise (the name is older than
    the port of XLA's log1p, when 4 ulp was the bound)."""
    import torch
    for key in (prng.prng_key(0), prng.split(prng.prng_key(3), 4)[2],
                _port_key(7, 5, 3)):
        want = np.asarray(jax.random.normal(jnp.asarray(key), shape,
                                            jnp.float32))
        got = (prng.normal(key, shape) if twin == "numpy" else
               prng.normal_torch(key, shape, "cpu").numpy())
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    if twin == "torch":
        assert prng.normal_torch(key, shape, "cpu").dtype == torch.float32


def test_normal_torch_chunks_agree(monkeypatch):
    """Drawn in passes of a few lanes, the torch twin gives the lanes it
    gives in one pass (lane i depends on i alone)."""
    key = prng.split(prng.prng_key(11), 3)[1]
    whole = prng.normal_torch(key, (37, 29), "cpu")
    monkeypatch.setattr(prng, "NORMAL_CHUNK", 100)
    import torch
    assert torch.equal(prng.normal_torch(key, (37, 29), "cpu"), whole)


def test_out_of_range_arguments_raise():
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 32)
    with pytest.raises(ValueError):
        prng.fold_in(prng.prng_key(0), -1)
    with pytest.raises(ValueError):
        prng.uniform_torch(prng.prng_key(0), (2 ** 16, 2 ** 16), "cpu")
