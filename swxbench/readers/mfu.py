"""The whole step's share of the card's dense bf16 peak, in %: events
scored over the stretch × the model's FLOP an event (counted from the
configuration's widths by its reference) over the stretch's seconds and
989 TFLOP/s. Only a run on the card has one."""

from swxbench.roofline import PEAK_BF16_FLOPS


def read(run):
    st = run.stretch
    if not run.on_card or st is None or st.t1 <= st.t0:
        return None
    events = st.delta("events")
    if events <= 0:
        return None
    flops = events * run.flops_per_event
    return 100.0 * flops / ((st.t1 - st.t0) * PEAK_BF16_FLOPS)
