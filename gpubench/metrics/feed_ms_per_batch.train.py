"""Host milliseconds a batch of the loader took to make (the harness's
clock around each ``next()`` of the loader it hands the loop), averaged
over the window's batches. Moves ``train_ex_per_s`` where the card waits
for the feed."""


def read(run):
    times = [w["feed_s"] for w in run.work if not w.get("warm")]
    return 1e3 * sum(times) / len(times) if times else None
