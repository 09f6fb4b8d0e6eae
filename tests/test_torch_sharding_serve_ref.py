"""The sharded prefill and decode of the port (``repro_torch.sharding.serve``)
against the reference's own ``repro.models.prefill`` and ``decode_step``:
nemotron-4-15b's smoke variant in float32, the reference's parameters
carried across by ``convert.lm_params_from_numpy``, a B = 8 x 16 prompt and
4 teacher-forced decode steps in a cache of 24 slots.  The reference runs
in the main process; one ``distributed.spawn`` of 4 gloo ranks then runs
the 2 x 2 grid (kv heads over ``model``) and the 1 x 4 grid (the cache
length over ``model``).  Bound: tests/test_torch_dense_lm.py's decode
bound, 3e-4 absolute + 3e-4 relative, on the logits of the rank's rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jm
from repro.configs import get_config as j_get_config
from repro_torch import convert, distributed
from repro_torch.configs import get_config
from test_torch_sharding_serve import STEPS, sharded_logits

torch.set_num_threads(1)

ARCH = "nemotron-4-15b"
GRIDS = [(2, 2), (1, 4)]
B, PROMPT, MAX_SEQ = 8, 16, 24
TOL = 3e-4


def _tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (B, PROMPT + STEPS))


def _reference():
    """(the reference's parameters as numpy, its prefill and decode logits)."""
    cfg = j_get_config(ARCH, variant="smoke")
    params = jm.init_params(cfg, jax.random.PRNGKey(2))
    toks = jnp.asarray(_tokens(cfg).astype(np.int32))
    cache = jm.init_cache(cfg, B, MAX_SEQ)
    logits, cache = jm.prefill(cfg, params, {"tokens": toks[:, :PROMPT]}, cache)
    out = [np.asarray(logits)]
    for t in range(STEPS):
        logits, cache = jm.decode_step(cfg, params, toks[:, PROMPT + t:PROMPT + t + 1], cache,
                                       PROMPT + t)
        out.append(np.asarray(logits))
    return jax.tree.map(np.asarray, params), out


@pytest.fixture(scope="module")
def runs():
    jparams, want = _reference()
    cfg = get_config(ARCH, variant="smoke")
    state = dict(convert.lm_params_from_numpy(jparams, cfg, device="cpu").named_parameters())
    state = {k: v.detach() for k, v in state.items()}
    toks = torch.as_tensor(_tokens(cfg))
    return want, distributed.spawn(sharded_logits, 4, cfg, state, toks, PROMPT, MAX_SEQ, GRIDS,
                                   device="cpu")


@pytest.mark.parametrize("step", range(STEPS + 1))
@pytest.mark.parametrize("shape", GRIDS, ids=[f"{d}x{m}" for d, m in GRIDS])
def test_sharded_serving_matches_the_reference(runs, shape, step):
    want, ranks = runs
    for rank, res in enumerate(ranks):
        rows, got = res[shape]
        np.testing.assert_allclose(got[step].numpy(), want[step][rows.numpy()], atol=TOL,
                                   rtol=TOL,
                                   err_msg=f"rank {rank} step {step}")
