"""Millisecond attribution of the urban RK3 step via an ablation ladder.

Each rung re-traces the FULL step with one more IBM term disabled
(`IBM.ablate`, ibm/ibm.py) and is timed as a real chained `lax.scan` —
the same methodology as bench.py, so rung differences attribute the cost
of each term and the rows sum to (urban - base) BY CONSTRUCTION.
Fusion-boundary effects stay inside the step being measured, unlike
phase-in-isolation timing which double-counts shared reads.

Usage: python prof_urban.py [N] [K]   (defaults 128, 20)
"""
import sys
import time

import jax


def chain_time(step, state, K, repeats=3):
    @jax.jit
    def loop(st):
        def body(s, _):
            return step(s), None
        out, _ = jax.lax.scan(body, st, None, length=K)
        return out

    jax.block_until_ready(loop(state))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(state))
        best = min(best, (time.perf_counter() - t0) / K)
    return best


LADDER = [
    ("full urban step", frozenset()),
    ("- heat wall fns", frozenset({"heat"})),
    ("- mom wall fns", frozenset({"heat", "mom"})),
    ("- diffusion corr", frozenset({"heat", "mom", "diffcorr"})),
    ("- advec corr", frozenset({"heat", "mom", "diffcorr", "advcorr"})),
    ("- solid_fill", frozenset({"heat", "mom", "diffcorr", "advcorr",
                                "fill"})),
    ("- mask zeroing", frozenset({"heat", "mom", "diffcorr", "advcorr",
                                  "fill", "masks"})),
]


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    from bench import _stage_urban
    from udales_jax.run import load_case
    case = _stage_urban(n)
    model = load_case(case, "900", dtype="float32")
    state = model.cold_start(seed=43)

    times = []
    for label, abl in LADDER:
        model.ibm.ablate = abl
        t = chain_time(model.step, state, K)
        times.append((label, t))
        print(f"{label:18s}: {t*1e3:7.3f} ms", flush=True)

    # flat + temperature comparator on the same physics switches but no IBM
    # machinery at all (the last rung still carries IBM interpolation-free
    # masked reductions etc. inside thermodynamics)
    print("\nladder differences (term costs):")
    total = times[0][1]
    for i in range(1, len(times)):
        d = times[i - 1][1] - times[i][1]
        print(f"  {LADDER[i][0][2:]:16s}: {d*1e3:6.3f} ms "
              f"({d/total*100:4.1f}%)")
    print(f"  base (no-IBM-terms step): {times[-1][1]*1e3:6.3f} ms "
          f"({times[-1][1]/total*100:4.1f}%)")
    print(f"  SUM check: {sum(times[i-1][1]-times[i][1] for i in range(1, len(times)))*1e3 + times[-1][1]*1e3:6.3f} "
          f"== {total*1e3:6.3f} ms")
    print(f"\nthroughput: {n**3/total/1e6:7.1f} M pts/s full urban")


if __name__ == "__main__":
    main()
