"""`paddle_tpu_torch obs top` — live fleet table, curses-free.

Renders the collector's /v1/obs/summary as a redraw-in-place terminal
table (ANSI cursor-home + clear-to-end between frames; plain sequential
frames when stdout is not a TTY, so piping to a file stays readable).
One row per live process:

    REPLICA ROLE V STEPS STEP/S P50 P99 QUEUE HBM CACHE HEALTH ST AGE

with ST flagging the replicas the collector currently attributes as
stragglers (fleet_straggler gauge), plus a fleet header line (process /
expired counts, pushes, dropped snapshots, max step skew).
"""

import json
import sys
import time

__all__ = ["fetch_summary", "render_summary", "run_top"]

_CLEAR = "\x1b[2J"        # clear screen (first frame)
_HOME = "\x1b[H"          # cursor home
_WIPE = "\x1b[J"          # clear from cursor to end


def fetch_summary(endpoint, timeout_s=3.0):
    """GET /v1/obs/summary from host:port -> dict (raises OSError)."""
    import http.client

    host, port = endpoint.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout_s)
    try:
        conn.request("GET", "/v1/obs/summary")
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            raise OSError(f"{endpoint}: HTTP {resp.status}")
        return json.loads(body.decode("utf-8", "replace"))
    finally:
        conn.close()


def _fmt(v, spec="{:.1f}", dash="-"):
    if v is None:
        return dash
    try:
        return spec.format(v)
    except (ValueError, TypeError):
        return dash


def _fmt_bytes(n):
    if n is None:
        return "-"
    n = float(n)
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024.0 or unit == "TB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0


def render_summary(summary):
    """Summary dict -> multi-line table string (no ANSI; the caller owns
    screen control)."""
    fleet = summary.get("fleet", {})
    lines = []
    skew = fleet.get("max_skew_ms")
    stragglers = fleet.get("stragglers") or {}
    lines.append(
        f"fleet: {fleet.get('processes', 0)} up"
        f" / {fleet.get('expired', 0)} expired"
        f"   pushes {int(fleet.get('pushes') or 0)}"
        f"   scrapes {int(fleet.get('scrapes') or 0)}"
        f"   dropped {int(fleet.get('dropped_snapshots') or 0)}"
        f"   steps(multi) {fleet.get('multi_replica_steps', 0)}"
        f"   max skew {_fmt(skew)} ms")
    if stragglers:
        worst = ", ".join(f"{k} x{v}" for k, v in
                          sorted(stragglers.items()))
        lines.append(f"stragglers: {worst}")
    hdr = (f"{'REPLICA':<18}{'ROLE':<9}{'V':<2}{'STEPS':>7}"
           f"{'STEP/S':>8}{'P50MS':>8}{'P99MS':>8}{'QUEUE':>6}"
           f"{'HBM':>9}{'CACHE%':>7}{'HLTH':>5}{'ST':>3}{'AGE':>6}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for p in summary.get("processes", []):
        lab = p.get("labels", {})
        hit = p.get("cache_hit_ratio")
        lines.append(
            f"{str(lab.get('replica', '?')):<18.17}"
            f"{str(lab.get('role', '?')):<9.8}"
            f"{'p' if p.get('via') == 'push' else 's':<2}"
            f"{_fmt(p.get('steps_total'), '{:.0f}'):>7}"
            f"{_fmt(p.get('step_rate'), '{:.2f}'):>8}"
            f"{_fmt(p.get('p50_ms')):>8}"
            f"{_fmt(p.get('p99_ms')):>8}"
            f"{_fmt(p.get('queue_rows'), '{:.0f}'):>6}"
            f"{_fmt_bytes(p.get('hbm_bytes')):>9}"
            f"{_fmt(hit * 100.0 if hit is not None else None):>7}"
            f"{_fmt(p.get('health_events'), '{:.0f}'):>5}"
            f"{'*' if p.get('straggler') else '':>3}"
            f"{_fmt(p.get('age_s')):>6}")
    for e in summary.get("expired", []):
        lab = e.get("labels", {})
        lines.append(f"{str(lab.get('replica', '?')):<18.17}"
                     f"{str(lab.get('role', '?')):<9.8}"
                     f"expired {_fmt(e.get('age_s'), '{:.0f}')}s ago")
    return "\n".join(lines)


def run_top(endpoint, interval_s=2.0, once=False, json_out=False,
            iterations=None, out=None):
    """The `obs top` loop. `once` prints a single frame; `iterations`
    bounds the loop (tests); returns 0, or 2 when the collector is
    unreachable on the first fetch."""
    out = out or sys.stdout
    inplace = (not once) and (not json_out) \
        and getattr(out, "isatty", lambda: False)()
    n = 0
    first = True
    while True:
        try:
            summary = fetch_summary(endpoint)
        except (OSError, ValueError) as e:
            if first:
                print(f"obs top: collector {endpoint} unreachable: {e}",
                      file=sys.stderr)
                return 2
            summary = None
        if summary is not None:
            if json_out:
                out.write(json.dumps(summary) + "\n")
            else:
                frame = (f"paddle_tpu_torch obs top — {endpoint} — "
                         f"{time.strftime('%H:%M:%S')}\n"
                         + render_summary(summary) + "\n")
                if inplace:
                    out.write((_CLEAR if first else "") + _HOME + frame
                              + _WIPE)
                else:
                    out.write(frame)
            out.flush()
        first = False
        n += 1
        if once or (iterations is not None and n >= iterations):
            return 0
        try:
            time.sleep(interval_s)
        except KeyboardInterrupt:
            return 0
