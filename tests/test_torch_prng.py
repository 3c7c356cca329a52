"""The port's counter-keyed PRNG (``repro_torch.prng``) against
``jax.random`` under JAX's defaults: the keys and the uniform draws equal
bit for bit, for the fault plan's (5,) draws and for (n_qblocks, qblock)
blocks of the shape the q4 wire's stochastic rounding draws, from the
numpy twin and from the torch-op twin the q4 codec uses (on the CPU
here; ``chip_smoke.py`` holds it to the numpy twin on the card)."""
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


def test_out_of_range_arguments_raise():
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 32)
    with pytest.raises(ValueError):
        prng.fold_in(prng.prng_key(0), -1)
    with pytest.raises(ValueError):
        prng.uniform_torch(prng.prng_key(0), (2 ** 16, 2 ** 16), "cpu")
