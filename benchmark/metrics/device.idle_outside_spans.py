"""Of the card's idle time in the traced sub-window, the share (%) during
which no program span (system., track., mapping., loop.) was open on the
host: idle time the program's own spans do not name."""

from harness.spans import idle_outside_share, span_intervals


def read(ctx):
    t = ctx.trace
    spans = span_intervals(t)
    if not spans:
        return None
    return idle_outside_share(t.window_s, [(s, e) for _n, s, e in t.device_ops],
                              spans)
