"""Shared set-up of the serving request-plane parity tests
(tests/test_torch_serve_robustness.py, test_torch_streaming.py and
test_torch_speculative.py).

A scenario is a function of one `Side`: the batcher class, fault
registry, drain guard and flag setter of one package, with that
package's model.  `both` runs a scenario on paddle_tpu and on the port
with the same numpy weights, the same fault spec and the same patched
clock, and requires the same record from each: every request's tokens,
the shed ids with their reasons, the partial ids, and the stats
counters."""
import numpy as np

import paddle_tpu as paddle
from paddle_tpu.distributed import fault as jfault
from paddle_tpu.distributed import guard as jguard
from paddle_tpu.inference import ContinuousBatcher as JBatcher
from paddle_tpu.models.llama import LlamaForCausalLM as JLlama
from paddle_tpu.models.llama import llama_tiny_config as j_tiny

from paddle_tpu_torch.distributed import fault as tfault
from paddle_tpu_torch.distributed import guard as tguard
from paddle_tpu_torch.framework.flags import set_flags as tset_flags
from paddle_tpu_torch.inference import ContinuousBatcher, generate
from paddle_tpu_torch.models import (LlamaForCausalLM, llama_tiny_config,
                                     load_numpy_state_dict)

# the reference serving tests' tiny Llama, in fp32 so both packages
# round alike
CFG = dict(dtype="float32", num_hidden_layers=2, hidden_size=64,
           intermediate_size=128, num_attention_heads=4,
           num_key_value_heads=2, vocab_size=128)

# stats() keys held equal across the packages
COUNTERS = ("chunks", "decode_chunks", "admit_chunks", "avg_occupancy",
            "prefill_tokens", "decode_tokens", "tokens_produced",
            "requests_submitted", "requests_admitted",
            "requests_completed", "requests_shed", "requests_requeued",
            "shed_by_class", "shed_rate_window", "deadline_misses",
            "chunk_retries", "callback_errors", "queued", "queued_by_class",
            "drained", "slo_attainment", "prefix_hit_tokens", "evictions",
            "cow_copies", "kv_pages_used", "kv_pages_free",
            "kv_pages_cached", "spec_tokens", "spec_drafted",
            "spec_accepted", "spec_accept_rate", "spec_accepted_per_step")


def numpy_weights(jmodel, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for name, p in jmodel.state_dict().items():
        shape = tuple(p.shape)
        if len(shape) == 1:
            out[name] = (1.0 + 0.1 * rng.randn(*shape)).astype(np.float32)
        else:
            out[name] = (rng.randn(*shape) / np.sqrt(shape[0])) \
                .astype(np.float32)
    return out


def model_pair(seed=1, **cfg):
    """(paddle_tpu model, port model) holding the same numpy weights."""
    kw = dict(CFG, **cfg)
    jm = JLlama(j_tiny(**kw))
    weights = numpy_weights(jm, seed)
    jm.set_state_dict(weights)
    tm = LlamaForCausalLM(llama_tiny_config(**kw), device="cpu")
    load_numpy_state_dict(tm, weights)
    return jm, tm


class Clock:
    """A patched batcher clock: starts at 1000 s and advances `tick`
    seconds a reading (0: only when a test moves `t`)."""

    def __init__(self, tick=0.0):
        self.t = 1000.0
        self.tick = tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t


class Side:
    """One package's serving surface."""

    def __init__(self, name, model, make, fault, guard, set_flags):
        self.name = name
        self.model = model
        self._make = make
        self.fault = fault
        self.guard = guard
        self.set_flags = set_flags

    def batcher(self, clock=None, model=None, **kw):
        bat = self._make(self.model if model is None else model, **kw)
        bat._now = clock if clock is not None else Clock()
        return bat


def sides(jm, tm):
    return [Side("paddle_tpu", jm, lambda m, **kw: JBatcher(m, **kw),
                 jfault, jguard, paddle.set_flags),
            Side("port", tm,
                 lambda m, **kw: ContinuousBatcher(m, device="cpu", **kw),
                 tfault, tguard, tset_flags)]


def record(bat, **extra):
    """What a scenario must reproduce: outputs, shed reasons, partial
    ids and the counters."""
    st = bat.stats()
    fin = bat._finished
    return dict(outs={r: [int(t) for t in q.output()] for r, q in fin.items()},
                shed={r: q.shed_reason for r, q in fin.items() if q.shed},
                partial=sorted(r for r, q in fin.items() if q.partial),
                stats={k: st[k] for k in COUNTERS if k in st}, **extra)


def both(pair, scenario):
    """Run `scenario(side)` on paddle_tpu, then on the port; the two
    records must be equal.  Returns the port's."""
    ref, port = (scenario(s) for s in sides(*pair))
    assert sorted(ref) == sorted(port)
    for key in ref:
        assert port[key] == ref[key], (key, port[key], ref[key])
    return port


def isolated(tm, prompt, n):
    """The port's isolated greedy generate() of one request."""
    return [int(t) for t in generate(tm, np.asarray(prompt)[None], n,
                                     device="cpu").numpy()[0]]


def no_leak(rec):
    st = rec["stats"]
    assert st["requests_submitted"] == st["requests_completed"] \
        + st["requests_shed"], st
    assert sorted(rec["outs"]) == list(range(st["requests_submitted"]))
