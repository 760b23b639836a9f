"""Host synchronisations a frame (a lane step with lanes) over the traced
run's measured window: those torch's sync debug mode reports, plus the
grouped fetch's event waits (``device.HostCopy.waits``), which it does not."""


def read(t):
    frames = t.counts.get("frames_synced", 0)
    if not frames:
        return None
    return (t.counts.get("host_syncs", 0) + t.counts.get("host_copy_waits", 0)) / frames
