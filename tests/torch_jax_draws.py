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


@jax.jit
def _redraw_ints(key, maxval):
    """The 64 candidates of JAX's bounded redraw loop from `key`: kk, sub =
    split(kk) each time, randint(sub, (), 0, maxval)."""
    def body(kk, _):
        kk, sub = jax.random.split(kk)
        return kk, jax.random.randint(sub, (), 0, maxval)

    return jax.lax.scan(body, key, None, length=64)[1]


def jax_mc_draws(kind, key, nmc, n_real, ns, dtype=jnp.float64):
    """JAX's MCMD block draws (gpumd_tpu/mc/mcmd.py), recomputed from its
    key sequence, as the port's MCDraws fields (atom, other, uniform) in
    numpy, and the key after the block.  Each trial splits key into (key,
    k1, k2, k3, k4).  Canonical: i from k1, j's first pick from k2 and its
    redraws from k3.  SGC/VC-SGC: i's first pick from k1 and its redraws
    from k2, the species' first pick from k3 and its redraws from the
    carried key, the stream the next trial's split starts from (JAX's
    reuse).  The uniform from k4."""
    atom, other, uniform = [], [], []
    for _ in range(nmc):
        key, k1, k2, k3, k4 = jax.random.split(key, 5)
        first = int(jax.random.randint(k1, (), 0, n_real))
        if kind == "canonical":
            atom.append([first] * 65)
            other.append([int(jax.random.randint(k2, (), 0, n_real))]
                         + np.asarray(_redraw_ints(k3, n_real)).tolist())
        else:
            atom.append([first]
                        + np.asarray(_redraw_ints(k2, n_real)).tolist())
            other.append([int(jax.random.randint(k3, (), 0, ns))]
                         + np.asarray(_redraw_ints(key, ns)).tolist())
        uniform.append(float(jax.random.uniform(k4, (), dtype)))
    return (np.asarray(atom), np.asarray(other), np.asarray(uniform)), key
