"""Host milliseconds of ``global_ba.build_global_problem`` a solve (the
host-side numpy assembly of the whole-trajectory problem), over the traced
run's measured window."""


def read(t):
    spans = t.spans.get("build_global_problem")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
