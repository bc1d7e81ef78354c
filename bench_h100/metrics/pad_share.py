"""Left-padded positions over all prefill positions of the window's
batches (the harness's wrapper on ``Server.generate_batch``), in %."""


def read(run):
    batches = [b for b in getattr(run.driver.rec, "batches", [])]
    if not batches:
        return None
    total = sum(len(b["prompts"]) * max(len(p) for p in b["prompts"])
                for b in batches)
    useful = sum(len(p) for b in batches for p in b["prompts"])
    return 100.0 * (total - useful) / total
