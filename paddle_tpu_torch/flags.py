"""Typed runtime flag registry.

Reference contrast: the reference scatters gflags across C++
(`FLAGS_check_nan_inf` in framework/executor.cc:27, FLAGS_benchmark,
FLAGS_fraction_of_gpu_memory_to_use, ...) plus `__bootstrap__` env parsing
in python/paddle/fluid/__init__.py:70. SURVEY §5 prescribes one typed
registry in their place: flags are declared once with a type, default and
help string, overridable from the environment using the reference's
familiar `FLAGS_<name>` variables, and read via flags.get() anywhere.

    from paddle_tpu_torch import flags
    flags.set("check_nan_inf", True)
    FLAGS_check_nan_inf=1 python train.py   # same effect
"""

import os
import threading

__all__ = ["define", "get", "set", "reset", "all_flags", "flag_guard"]

_lock = threading.Lock()
_defs = {}     # name -> (type, default, help)
_values = {}   # name -> current value


def _coerce(name, type_, raw):
    if type_ is bool:
        if isinstance(raw, str):
            return raw.strip().lower() in ("1", "true", "yes", "on")
        return bool(raw)
    try:
        return type_(raw)
    except (TypeError, ValueError) as e:
        raise ValueError(
            f"flag {name!r} expects {type_.__name__}, got {raw!r}") from e


def define(name, type_, default, help=""):
    """Declare a flag; the environment variable FLAGS_<name> (reference
    gflags convention) overrides the default at declaration time."""
    with _lock:
        if name in _defs:
            raise ValueError(f"flag {name!r} already defined")
        _defs[name] = (type_, default, help)
        env = os.environ.get(f"FLAGS_{name}")
        _values[name] = _coerce(name, type_, env) if env is not None \
            else default


def get(name):
    with _lock:
        if name not in _defs:
            raise KeyError(f"unknown flag {name!r}")
        return _values[name]


def set(name, value):
    with _lock:
        if name not in _defs:
            raise KeyError(f"unknown flag {name!r}")
        _values[name] = _coerce(name, _defs[name][0], value)


def reset(name=None):
    """Restore one flag (or all) to declared default / env override."""
    with _lock:
        names = [name] if name else list(_defs)
        for n in names:
            type_, default, _ = _defs[n]
            env = os.environ.get(f"FLAGS_{n}")
            _values[n] = _coerce(n, type_, env) if env is not None else default


def all_flags():
    """{name: (value, type, help)} snapshot (the --help surface)."""
    with _lock:
        return {n: (_values[n], _defs[n][0].__name__, _defs[n][2])
                for n in sorted(_defs)}


class flag_guard:
    """Temporarily override flags: `with flag_guard(check_nan_inf=True): ...`"""

    def __init__(self, **overrides):
        self._overrides = overrides
        self._saved = {}

    def __enter__(self):
        for n, v in self._overrides.items():
            self._saved[n] = get(n)
            set(n, v)
        return self

    def __exit__(self, *exc):
        for n, v in self._saved.items():
            set(n, v)
        return False


# ---------------------------------------------------------------------------
# Core flags, with the JAX package's names, types and defaults
# (paddle_tpu/flags.py)
# ---------------------------------------------------------------------------
define("check_nan_inf", bool, False,
       "Raise if a value holds NaN/Inf, naming the variable (reference "
       "executor.cc:343): on the interpreter after each op, naming the op "
       "too; on a captured step once after the run, over the fetches and "
       "the written state (one device reduction, read once).")
define("debug_nans", bool, False,
       "Trap the first NaN-producing computation (the analogue of the "
       "legacy trainer's feenableexcept FPE trapping, "
       "TrainerMain.cpp:47): a run under the flag goes to the "
       "interpreter, which checks each op's float outputs before its "
       "writes reach the scope and raises FloatingPointError naming the "
       "op and the output. Heavier than check_nan_inf's step-boundary "
       "scan; use to localize, not in production runs.")
define("benchmark", bool, False,
       "Synchronize and time each executor run (reference FLAGS_benchmark): "
       "after the run, wait for its last event, set the benchmark_run_ms "
       "gauge and print the time with the card's peak memory to stderr.")
define("monitor", bool, True,
       "Step-level training telemetry (paddle_tpu_torch.monitor): per-step "
       "phase breakdown, prepared-step cache hit/miss accounting, "
       "replica-skew gauges. Default ON — when set to 0 the per-step cost "
       "is a single flag check (asserted by "
       "tests/test_torch_monitor_step.py).")
define("monitor_journal", str, "",
       "Path of the JSONL step journal (one self-contained record per "
       "executor step; schema in paddle_tpu_torch/monitor/journal.py). "
       "Empty = no journal. Render with `python -m paddle_tpu_torch monitor "
       "<path>`.")

# ---------------------------------------------------------------------------
# Tracing flags, with the JAX package's defaults (paddle_tpu/trace/span.py,
# paddle_tpu/trace/recorder.py).
# ---------------------------------------------------------------------------
define("trace", bool, False,
       "Span-based tracing into the in-memory flight recorder "
       "(paddle_tpu_torch.trace): serve request lifecycles. Off by "
       "default; when 0 the hot-path cost is a single flag check.")
define("trace_buffer", int, 4096,
       "Flight-recorder capacity in spans PER THREAD (each recording "
       "thread owns one ring this size; older spans are overwritten and "
       "counted as dropped in the dump manifest).")
define("trace_dump_dir", str, "",
       "Directory flight-recorder dumps land in (trace_<reason>_<n>/ "
       "subdirectories); empty = current directory.")
define("trace_dump_cooldown_s", float, 60.0,
       "Minimum seconds between automatic flight-recorder dumps PER "
       "trigger reason (maybe_dump). 0 = dump every trigger.")
define("trace_dump_keep", int, 0,
       "Retention cap on trace_<reason>_<n>/ dump directories: after each "
       "dump the oldest beyond this many are pruned. 0 = keep everything.")
