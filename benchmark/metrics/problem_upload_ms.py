"""Host milliseconds of the port's ``global.upload`` span (``utils/profiling``:
the BAL problem's raw arrays copied from pinned host memory to the card by
``io/bal.to_problem``), the mean over the traced run's measured window."""


def read(t):
    spans = [s for s in t.context.get("program_spans", ()) if s.name == "global.upload"]
    if not spans:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / len(spans)
