"""Show that a process's first multi-threaded CPU `torch.exp` can return
a wrong chunk.

Each of N fresh Python processes computes exp of the same [24, 300]
fp32 tensor three times: first on torch's default thread pool (the
process's first parallel unary op), again on the pool, then on one
thread.  A process counts as hit when its first result differs from the
one-thread result; the second result is printed for contrast.  The
unary math kernels split tensors over 2048 elements across threads, so
a hit spans whole 2048-element chunks (rows of 300).

    python3 tools/torch_first_exp_race.py [--procs 240] [--jobs 4]

Prints one line per hit process and a summary; exits 0 either way.
The port's tests run torch on one CPU thread (tests/torch_cpu.py)
because of this.
"""
import argparse
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = r"""
import json, numpy as np, torch
x = torch.from_numpy(
    (np.random.RandomState(0).randn(24, 300) * 3).astype(np.float32))
y = x - x.amax(-1, keepdim=True)
first, second = torch.exp(y), torch.exp(y)
torch.set_num_threads(1)
single = torch.exp(y)
bad = first != single
rel = ((first - single).abs() / single.abs()).max().item()
print(json.dumps(dict(first=int(bad.sum()), second=int((second != single)
                      .sum()), rows=sorted(set(bad.nonzero()[:, 0].tolist())),
                      max_rel=rel)))
"""


def one(_):
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                         text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=240)
    ap.add_argument("--jobs", type=int, default=4)
    a = ap.parse_args()
    with ThreadPoolExecutor(a.jobs) as pool:
        res = list(pool.map(one, range(a.procs)))
    hits = [r for r in res if r["first"]]
    for r in hits:
        print(f"first call: {r['first']} of 7200 entries wrong (max "
              f"relative error {r['max_rel']:.3g}, rows {r['rows']}); "
              f"second call: {r['second']} wrong")
    print(f"{len(hits)} of {a.procs} processes got a wrong first exp; "
          f"{sum(bool(r['second']) for r in res)} a wrong second one")


if __name__ == "__main__":
    main()
