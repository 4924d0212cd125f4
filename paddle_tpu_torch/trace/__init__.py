"""paddle_tpu_torch.trace — span tracing and the flight recorder.

The monitor (paddle_tpu_torch.monitor) answers "what is the average";
trace answers "why was THIS one slow". The serving path is instrumented
end to end: serve.http -> serve.request -> queue/pad/dispatch/readback
child spans per request; the batcher's fan-in dispatch is a serve.batch
span LINKED to every coalesced request's context, so one slow request
stays attributable after batching.

Spans land in an in-memory flight recorder (recorder.py): per-thread
fixed-size rings, dumped (spans.jsonl + chrome trace.json +
manifest.json, export.py) on a serve SLO violation or ServerOverloaded,
on a model-health detector event, or on demand (dump()). The dump format
is the JAX package's (paddle_tpu/trace), with its per-op cost attribution
(costs.py: the compile probe's FLOPs spread over the program's ops by an
analytic estimate) in the manifest.

Off contract (FLAGS_trace=0, the default): one flag check per
instrumentation site, no allocation — same deal as FLAGS_monitor.
"""

from .costs import (attribute_costs, format_ops_table, op_costs,
                    register_program, registered_fingerprints,
                    slowest_ops)
from .export import CHROME_PID, FORMAT, chrome_events, load_dump, write_dump
from .recorder import (append, dump, last_dump, maybe_dump, reset,
                       snapshot)
from .span import (SpanContext, attach, current, enabled, new_context,
                   record, span)

__all__ = [
    # span API
    "SpanContext", "enabled", "current", "new_context", "attach", "span",
    "record",
    # flight recorder
    "append", "snapshot", "reset", "dump", "maybe_dump", "last_dump",
    # dump formats
    "FORMAT", "CHROME_PID", "chrome_events", "write_dump", "load_dump",
    # per-op cost attribution
    "register_program", "registered_fingerprints", "op_costs",
    "attribute_costs", "slowest_ops", "format_ops_table",
]
