"""Sampling in paddle_tpu_torch's `generate` against paddle_tpu's
`_sample`, on the CPU.

`jax.random.categorical(key, l)` is the argmax of `l` plus
`jax.random.gumbel(key, l.shape)` (asserted first, on unfiltered
logits), so the reference's draw for a key is fixed by the logits it
filters.  For 200 keys at each (temperature, top_k, top_p) point — tied
logits among them — the reference `_sample` must pick exactly the token
`argmax(sample_filter(logits) + gumbel(key))` picks with the port's
filter.  The port's own draws (a torch.Generator's Gumbel noise) must
repeat for a seed, reduce to greedy under top_k=1, and follow the
filtered distribution."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import model_pair

from paddle_tpu.inference.generation import _sample

from paddle_tpu_torch.inference import generate, sample_filter

POINTS = [  # (temperature, top_k, top_p)
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.8, 3, 0.6),
    (1.0, 1, None), (0.5, None, 0.0), (2.0, 40, 0.95), (1.0, 4, 0.5)]


def _logits(seed, ties):
    rng = np.random.RandomState(seed)
    lg = rng.randn(3, 64).astype(np.float32) * 2.0
    if ties:
        # few distinct values: top-k thresholds and the sorted order
        # fall among equal logits
        lg = np.round(lg * 2.0) / 2.0
    return lg


def _keys(n):
    return jax.random.split(jax.random.PRNGKey(1234), n)


def test_categorical_is_gumbel_argmax():
    lg = _logits(0, ties=False)
    for key in _keys(50):
        got = np.asarray(jax.random.categorical(key, jnp.asarray(lg),
                                                axis=-1))
        g = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))
        np.testing.assert_array_equal(got, np.argmax(lg + g, axis=-1))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("temperature,top_k,top_p", POINTS)
def test_filter_picks_the_reference_samples(temperature, top_k, top_p,
                                            ties):
    lg = _logits(1 + ties, ties)
    filt = sample_filter(torch.as_tensor(lg), temperature, top_p,
                         top_k).numpy()
    assert filt.dtype == np.float32
    # masked logits are -1e30 and the top token always survives
    assert ((filt == np.float32(-1e30)) | (filt > -1e29)).all()
    assert (filt[np.arange(3), lg.argmax(-1)] > -1e29).all()
    for key in _keys(200):
        want = np.asarray(_sample(jnp.asarray(lg), key, temperature, top_p,
                                  top_k))
        g = np.asarray(jax.random.gumbel(key, lg.shape, jnp.float32))
        np.testing.assert_array_equal(np.argmax(filt + g, axis=-1), want)


def test_port_draws_follow_the_filtered_distribution():
    """20000 draws of one row (the port's Gumbel noise) against the
    softmax of its filtered logits: every frequency within 5 standard
    errors, masked tokens never drawn."""
    from paddle_tpu_torch.inference.generation import _next_token
    lg = torch.as_tensor(_logits(5, ties=False)[:1]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(3)
    toks = _next_token(lg, 0.9, 0.8, 10, gen).numpy()
    p = torch.softmax(sample_filter(lg[:1], 0.9, 0.8, 10), -1)[0].numpy()
    freq = np.bincount(toks, minlength=p.size) / toks.size
    se = np.sqrt(p * (1 - p) / toks.size) + 1e-12
    assert (np.abs(freq - p) <= 5 * se + 1e-4).all()
    assert freq[p == 0].sum() == 0


@pytest.fixture(scope="module")
def tm():
    torch.manual_seed(0)
    return model_pair(seed=5)[1]


def test_generate_sampling_seeded_and_greedy_limits(tm):
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, 128, (2, 5)).astype(np.int32)
    kw = dict(device="cpu")
    a = generate(tm, prompt, 8, temperature=0.8, top_p=0.9, seed=7, **kw)
    b = generate(tm, prompt, 8, temperature=0.8, top_p=0.9, seed=7, **kw)
    assert torch.equal(a, b)
    assert a.dtype == torch.int32 and a.shape == (2, 8)
    assert int(a.min()) >= 0 and int(a.max()) < 128
    greedy = generate(tm, prompt, 8, **kw)
    assert torch.equal(generate(tm, prompt, 8, temperature=1.0, top_k=1,
                                seed=1, **kw), greedy)
    # a different seed draws differently somewhere at temperature 2
    draws = {tuple(generate(tm, prompt, 8, temperature=2.0, seed=s,
                            **kw).reshape(-1).tolist()) for s in range(4)}
    assert len(draws) > 1
    # eos pads the rest of a finished row, as in greedy mode
    eos = int(a[0, 2])
    c = generate(tm, prompt, 8, temperature=0.8, top_p=0.9, seed=7,
                 eos_token_id=eos, **kw)
    row = c[0].tolist()
    first = row.index(eos)
    assert row[first:] == [eos] * (8 - first)
