"""Events scored over the stretch per dispatch of the scorer (the
program's `scoring.dispatches` counter across the stretch)."""


def read(run):
    st = run.stretch
    if st is None:
        return None
    dispatches = st.delta("dispatches")
    events = st.delta("events")
    return events / dispatches if dispatches > 0 and events > 0 else None
