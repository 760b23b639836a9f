"""Host milliseconds of the port's ``frame.evict`` span (``utils/profiling``:
the eviction program's launches and the archive's copy, opened by
``process_image`` / ``process_images`` in slide mode), the mean over the
traced run's measured window, where the device waits for it between two
frames' replays."""


def read(t):
    spans = [s for s in t.context.get("program_spans", ()) if s.name == "frame.evict"]
    if not spans:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / len(spans)
