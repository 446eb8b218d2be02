"""Host time to enqueue one update: from calling the step to its return,
before the sync that reads the loss, averaged over the window's updates."""


def read(t: dict):
    spans = t.get("enqueue_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
