"""Mean duration in ms of one program span stage over the traced stretch
(every trace sampled there)."""


def read(run, stage: str):
    st = run.stretch
    if st is None or not st.spans.get(stage):
        return None
    spans = st.spans[stage]
    return 1e3 * sum(s.duration_s for s in spans) / len(spans)
