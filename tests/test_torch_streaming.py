"""Streaming `on_token` of paddle_tpu_torch's ContinuousBatcher against
paddle_tpu's, on the CPU, as tests/test_serving.py:174-298 pins it for
the reference: the bursts of each request concatenate to its output,
`done` fires once, nothing past EOS is sent, callback errors are
counted, and a requeued or shed request never gets a token twice nor
loses one it was sent.  Both packages must deliver the same bursts in
the same order (tests/torch_serve_pair.py)."""
import numpy as np
import pytest
import torch
from torch_cpu import one_cpu_thread  # noqa: F401 (autouse)
from torch_serve_pair import both, isolated, model_pair, record

GEOM = dict(max_len=64, chunk=4, prefill_chunk=4)


@pytest.fixture(scope="module")
def pair():
    torch.manual_seed(0)
    return model_pair(seed=7)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, L).astype(np.int32) for L in lens]


def _collector():
    events = {}

    def cb(rid, toks, done):
        events.setdefault(rid, []).append(([int(t) for t in toks], done))
    return events, cb


def test_streaming_callbacks_match_outputs(pair):
    prompts = _prompts(21, (5, 9, 4))

    def scenario(side):
        events, cb = _collector()
        bat = side.batcher(max_batch_size=2, **GEOM)
        for p in prompts:
            bat.submit(p, 6, on_token=cb)
        bat.run()
        return record(bat, events=events)

    rec = both(pair, scenario)
    for rid in range(3):
        bursts = rec["events"][rid]
        assert [t for ts, _ in bursts for t in ts] == rec["outs"][rid]
        assert [d for _, d in bursts].count(True) == 1 and bursts[-1][1]
        # 6 tokens through chunk=4 take more than one burst
        assert len([b for b, _ in bursts if b]) >= 2
        assert rec["outs"][rid] == isolated(pair[1], prompts[rid], 6)


def test_streaming_never_delivers_past_eos(pair):
    prompt = _prompts(22, (5,))[0]
    # the greedy first token as EOS: the request ends mid-chunk
    first = isolated(pair[1], prompt, 1)[0]

    def scenario(side):
        got = []
        bat = side.batcher(max_batch_size=1, eos_token_id=first, **GEOM)
        bat.submit(prompt, 8, on_token=lambda r, t, d: got.extend(
            int(x) for x in t))
        bat.run()
        return record(bat, got=got)

    rec = both(pair, scenario)
    assert rec["got"] == rec["outs"][0] == [first]


def test_streaming_callback_errors_counted_not_fatal(pair):
    prompt = _prompts(23, (5,))[0]

    def bad(rid, toks, done):
        raise RuntimeError("consumer went away")

    def scenario(side):
        bat = side.batcher(max_batch_size=1, **GEOM)
        bat.submit(prompt, 5, on_token=bad)
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert len(rec["outs"][0]) == 5                 # batch unharmed
    assert rec["stats"]["callback_errors"] >= 1


def test_streaming_requeue_no_duplicate_delivery(pair):
    prompts = _prompts(24, (5, 7))

    def scenario(side):
        events, cb = _collector()
        with side.fault.scope("serve.decode:step=3:mode=error"):
            bat = side.batcher(max_batch_size=2, **GEOM)
            for p in prompts:
                bat.submit(p, 6, on_token=cb)
            bat.run()
        return record(bat, events=events)

    rec = both(pair, scenario)
    assert rec["stats"]["requests_requeued"] == 1 and rec["shed"] == {}
    for rid in range(2):
        streamed = [t for ts, _ in rec["events"][rid] for t in ts]
        assert streamed == rec["outs"][rid]
        assert rec["outs"][rid] == isolated(pair[1], prompts[rid], 6)


def test_streaming_shed_after_fault_keeps_delivered_prefix(pair):
    prompt = _prompts(25, (5,))[0]

    def scenario(side):
        events = []
        with side.fault.scope("serve.decode:step=3:mode=error:times=*"):
            bat = side.batcher(max_batch_size=1, **GEOM)
            bat.submit(prompt, 8, on_token=lambda r, t, d: events.append(
                ([int(x) for x in t], d)))
            bat.run()
        return record(bat, events=events)

    rec = both(pair, scenario)
    assert rec["shed"] == {0: "decode_fault"} and rec["partial"] == [0]
    streamed = [t for ts, _ in rec["events"] for t in ts]
    assert streamed and streamed == rec["outs"][0]
    assert [d for _, d in rec["events"]].count(True) == 1


def test_streaming_callback_may_submit(pair):
    """on_token may call submit() (the queue lock is reentrant): a
    follow-up request submitted from a done callback is served too."""
    p1, p2 = _prompts(27, (5, 6))

    def scenario(side):
        bat = side.batcher(max_batch_size=1, **GEOM)

        def cb(rid, toks, done):
            if done and rid == 0:
                bat.submit(p2, 4)
        bat.submit(p1, 4, on_token=cb)
        bat.run()
        return record(bat)

    rec = both(pair, scenario)
    assert sorted(rec["outs"]) == [0, 1]
    assert rec["outs"][1] == isolated(pair[1], p2, 4)
