"""Benchmark driver.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

Headline metric (BASELINE config 2, the north star): aggregate warm
QP-solves/sec for a vmapped fleet of dense strongly-convex QPs
(n_eq = n/4, n_ineq = n/2), solved with the batched condensed-Cholesky
device backend under two-phase mixed precision (f32 factors while the
barrier is loose, f64 endgame; identical eps_abs = 1e-8 accuracy,
docs/backends.md).  Attempts sweep n and the best vs_baseline is reported,
with every measured config in extra.all_attempts.

vs_baseline divides by the REAL reference solver: benchmarks/ref_driver.cpp
builds the actual PIQP C++ and solves the byte-identical problems
single-core with warm update+solve rounds — measured numbers and full
provenance in benchmarks/ref_baseline.json.

Each device config runs in its own subprocess (benchmarks/northstar_bench.py,
one JAX process on the card at a time), which fails unless JAX finds a
GPU; bench.py then reports an error record and exits nonzero.

Robustness: a global wall-clock budget (BENCH_BUDGET_S, default 1380 s)
enforced with SIGALRM, per-attempt subprocess timeouts carved out of the
remaining budget, and SIGTERM/SIGALRM handlers that print the best result
gathered so far (or an error record) as the final JSON line.
"""

import json
import os
import signal
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
REF_BASELINE = os.path.join(REPO, "benchmarks", "ref_baseline.json")

BUDGET_S = float(os.environ.get("BENCH_BUDGET_S", "1380"))
_T0 = time.monotonic()

# (dim, B, chunk, mixed, pallas, static_passes, timeout cap) attempts,
# run in order while budget lasts; a SUCCESS replaces the reported payload
# only when its vs_baseline is HIGHER (so a later attempt can never lose
# the result in hand).  static_passes is the phase-A refinement policy knob
# (types.Settings.refine_static_passes; "d" = library default).  The final
# field caps the attempt's timeout in seconds (None = remaining budget).
# The choice of cells is not yet measured on the GPU.
ATTEMPTS = [
    (1024, 128, 4, 1, 1, "-1", 760),
    (512, 256, 16, 1, 1, "-1", None),
    (128, 256, 128, 1, 1, "-1", None),
    (256, 256, 64, 1, 1, "-1", None),
    (64, 256, 128, 1, 1, "-1", None),
    (64, 1024, 256, 1, 1, "d", None),
    (64, 256, 128, 0, 0, "d", None),
]

# Fused K-rounds-per-dispatch SQP attempt (batch.solve_batch_sqp): K warm
# update+re-solve rounds ride ONE executable — the batched expression of
# the reference's warm SQP loop (sqp_benchmarks.cpp:16-120), and the same
# work the warm_qps baseline counts.  Runs after a northstar result is in;
# upgrades the headline when its warm solves/s is higher.
# (dim, B, rounds, mixed)
FUSED_ATTEMPTS = [
    (64, 256, 16, 1),
]

METRIC = "aggregate warm QP-solves/sec (config 2: vmapped dense QPs; n and B in extra)"

# Best payload gathered so far; the signal handlers print this.
_payload = {
    "metric": METRIC,
    "value": 0.0,
    "unit": "solves/sec",
    "vs_baseline": 0.0,
    "error": "bench interrupted before any config completed",
}
_printed = False
_child = None  # active benchmark subprocess, killed by the signal handler
_attempts_log = []  # every successful config, for extra.all_attempts


def _remaining():
    return BUDGET_S - (time.monotonic() - _T0)


def _emit_and_exit(signum=None, frame=None):
    """Print the best-so-far JSON line exactly once and exit."""
    global _printed
    if not _printed:
        _printed = True
        extra = _payload.get("extra")
        if extra is not None and not extra.get("attempt_errors"):
            extra["attempt_errors"] = None
        print(json.dumps(_payload), flush=True)
    if _child is not None and _child.poll() is None:
        try:
            _child.kill()
        except OSError:
            pass
    # os._exit so a SIGTERM from an outer `timeout` still leaves a clean
    # parseable tail rather than a traceback; nonzero without a result
    os._exit(0 if "error" not in _payload else 1)


def run_config(dim, B, chunk, mixed, pallas, timeout, sp="d"):
    global _child
    cmd = [
        sys.executable,
        os.path.join(REPO, "benchmarks", "northstar_bench.py"),
        str(dim), str(B), str(chunk), str(mixed), str(pallas),
    ]
    cenv = dict(os.environ)
    cenv["PIQP_NS_STATIC_PASSES"] = sp
    _child = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=cenv,
    )
    try:
        stdout, stderr = _child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _child.kill()
        _child.communicate()
        return None, "timeout(%ds)" % timeout
    if _child.returncode != 0:
        return None, (stderr or stdout)[-500:]
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line), None
        except json.JSONDecodeError:
            continue
    return None, "no JSON in output"


def run_fused(dim, B, rounds, mixed, timeout):
    global _child
    cmd = [
        sys.executable,
        os.path.join(REPO, "benchmarks", "sqp_fused_bench.py"),
        str(dim), str(B), str(rounds), str(mixed),
    ]
    cenv = dict(os.environ)
    # adaptive refinement (cold-stall robustness is irrelevant to the warm
    # fused loop)
    cenv["PIQP_FUSED_STATIC_PASSES"] = "-1"
    _child = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=cenv,
    )
    try:
        stdout, stderr = _child.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _child.kill()
        _child.communicate()
        return None, "timeout(%ds)" % timeout
    if _child.returncode != 0:
        return None, (stderr or stdout)[-500:]
    for line in reversed(stdout.strip().splitlines()):
        try:
            return json.loads(line), None
        except json.JSONDecodeError:
            continue
    return None, "no JSON in output"


def main():
    signal.signal(signal.SIGTERM, _emit_and_exit)
    signal.signal(signal.SIGALRM, _emit_and_exit)
    # hard backstop 20 s before the budget so the final line always lands
    # (clamped so a tiny BENCH_BUDGET_S can never push the alarm past it)
    signal.alarm(int(min(max(10, BUDGET_S - 20), BUDGET_S)))

    with open(REF_BASELINE) as f:
        ref = json.load(f)

    errors = []
    got_any = False
    for dim, B, chunk, mixed, pallas, sp, cap in ATTEMPTS:
        slice_s = _remaining() - 30  # leave room to print
        if slice_s < 60 or (got_any and slice_s < 420):
            # never risk the recorded result for an upgrade with too
            # little budget left
            errors.append("budget exhausted before B=%d attempt" % B)
            break
        if cap is not None:
            slice_s = min(slice_s, cap)
        res, err = run_config(dim, B, chunk, mixed, pallas,
                              timeout=int(slice_s), sp=sp)
        if res is not None:
            # score by vs_baseline (the BASELINE.json target is a RATIO
            # to the single-core reference; dims differ across attempts)
            refc = ref["configs"][str(res["dim"])]
            vs = res["warm_qps_per_s"] / refc["warm_qps_per_s"]
            _attempts_log.append(dict(
                n=res["dim"], B=res["B"], static_passes=sp,
                warm_qps_per_s=res["warm_qps_per_s"], vs=round(vs, 3),
            ))
            if vs > _payload["vs_baseline"]:
                _record(res, ref, errors, sp)
            got_any = True
            continue
        errors.append(f"B={B},chunk={chunk},mixed={mixed},pallas={pallas}: {err}")

    # Fused upgrade pass: only after a northstar result is recorded (the
    # fused number replaces the value only when it is strictly better, so
    # this can never lose the result already in hand).
    if got_any:
        for dim, B, rounds, mixed in FUSED_ATTEMPTS:
            slice_s = _remaining() - 30
            if slice_s < 300:
                errors.append("budget exhausted before fused B=%d" % B)
                break
            res, err = run_fused(dim, B, rounds, mixed,
                                 timeout=int(slice_s))
            if res is None:
                errors.append(f"fused B={B},K={rounds}: {err}")
                continue
            refc = ref["configs"][str(res["dim"])]
            if res["fused_qps_per_s"] / refc["warm_qps_per_s"] > _payload["vs_baseline"]:
                _record_fused(res, ref)
                break  # first win is the headline

    if not got_any:
        _payload["error"] = "; ".join(errors)[-1200:]
    elif _payload.get("extra") is not None:
        _payload["extra"]["all_attempts"] = _attempts_log
    _emit_and_exit()


def _record_fused(res, ref):
    """Upgrade the headline to the fused K-rounds-per-dispatch number.
    Same work the baseline's warm pass counts (K update+re-solve rounds,
    sqp_benchmarks.cpp:16-120), executed as ONE executable per K rounds."""
    refc = ref["configs"][str(res["dim"])]
    value = res["fused_qps_per_s"]
    extra = _payload.get("extra") or {}
    extra.update({
        "fused": {
            "B": res["B"], "rounds": res["rounds"],
            "mixed_precision": bool(res["mixed"]),
            "solved": res["solved"], "total": res["total"],
            "mean_round_iters": res["mean_round_iters"],
            "us_per_problem_iter": res["us_per_problem_iter"],
            "eff_gflops": res["eff_gflops"],
            "note": "K warm update+re-solve rounds per dispatch "
                    "(batch.solve_batch_sqp); dispatch-per-round "
                    "figure in plain_warm_qps_per_s",
        },
        "plain_warm_qps_per_s": _payload["value"],
        "eff_gflops": res["eff_gflops"],
        "iter_us_per_problem": res["us_per_problem_iter"],
    })
    _payload.update({
        "value": round(value, 1),
        "vs_baseline": round(value / refc["warm_qps_per_s"], 3),
        "extra": extra,
    })


def _record(res, ref, errors, sp="d"):
    """Fold a successful config into the reported payload (the signal
    handlers print whatever is recorded here if the driver times out)."""
    refc = ref["configs"][str(res["dim"])]
    value = res["warm_qps_per_s"]
    vs = value / refc["warm_qps_per_s"]
    _payload.pop("error", None)
    _payload.update({
        "value": round(value, 1),
        "vs_baseline": round(vs, 3),
        "extra": {
            "device": res["device"],
            "B": res["B"], "chunk": res["chunk"],
            "mixed_precision": bool(res["mixed"]),
            "pallas_kernels": bool(res.get("pallas")),
            "refine_static_passes": sp,
            "plain_warm_qps_per_s": res.get("plain_warm_qps_per_s"),
            "cold_qps_per_s": res["cold_qps_per_s"],
            "solved": res["solved"], "warm_solved": res["warm_solved"],
            "max_iters": res["max_iters"],
            "warm_max_iters": res.get("warm_max_iters"),
            "compaction": res.get("compaction"),
            "stragglers": res.get("stragglers"),
            "phase1": res.get("phase1"),
            "eff_gflops": res.get("eff_gflops"),
            "iter_us_per_problem": res.get("iter_us_per_problem"),
            "baseline": {
                "what": "real reference PIQP C++, single-core, warm update+solve, identical problems",
                "warm_qps_per_s": refc["warm_qps_per_s"],
                "cold_qps_per_s": refc["cold_qps_per_s"],
                "provenance": "benchmarks/ref_baseline.json",
            },
            # keep the LIVE list so errors appended after this record (e.g.
            # "budget exhausted") still land in the emitted payload
            "attempt_errors": errors,
        },
    })


if __name__ == "__main__":
    main()
