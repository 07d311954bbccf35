"""JAX's random draws, recomputed with JAX's key sequence, for injection
into the port's stochastic ensembles and drivers: the two packages draw
different streams, so a parity test hands the port JAX's numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

SEED = 12345  # the ensembles' default seed in both packages


class FixedDraws:
    """A numpy-generator stand-in returning the given draws in order
    (standard_normal(size) or gamma(shape)), as the port's BDP and SCR
    ask for them."""

    def __init__(self, draws):
        self.q = [x for d in draws for x in d]

    def standard_normal(self, size=None):
        v = self.q.pop(0)
        return v if size is None else np.reshape(v, size)

    def gamma(self, shape):
        return self.q.pop(0)


def jax_bdp_draws(n_steps, ndeg, scr, seed=SEED):
    """JAX's NVTBDP / NPTSCR draws a step from PRNGKey(seed): a normal, a
    Gamma((ndeg - 1) / 2) and, for SCR, xi (3,)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_steps):
        if scr:
            key, k1, k2, k3 = jax.random.split(key, 4)
        else:
            key, k1, k2 = jax.random.split(key, 3)
        d = [float(jax.random.normal(k1, (), jnp.float64)),
             float(jax.random.gamma(k2, 0.5 * (ndeg - 1.0),
                                    dtype=jnp.float64))]
        if scr:
            d.append(np.asarray(jax.random.normal(k3, (3,), jnp.float64)))
        out.append(d)
    return out


def jax_half_kick_draws(n_draws, shape, seed=SEED):
    """JAX's NVTLangevin / NVTBAOAB noise: one (N, 3) normal a draw, from
    key, sub = split(key) starting at PRNGKey(seed)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_draws):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(sub, shape, jnp.float64)))
    return out


def popping_draw(arrays):
    """draw(shape, dtype, device) handing out `arrays` in order."""
    queue = list(arrays)

    def draw(shape, dtype, device):
        a = queue.pop(0)
        assert tuple(a.shape) == tuple(shape)
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    draw.queue = queue
    return draw


def jax_random_force_draws(steps, shape, seed=20240813):
    """JAX's AddRandomForce noise at each state.step in `steps`: a normal
    from fold_in(PRNGKey(seed), step)."""
    base = jax.random.PRNGKey(seed)
    return [np.asarray(jax.random.normal(jax.random.fold_in(base, s), shape,
                                         jnp.float64)) for s in steps]
