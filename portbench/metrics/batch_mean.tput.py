"""Mean images a dispatch in the traced window: the program's own
``ServerStats`` counters (images over batches), read at the window's
edges. Layer: batcher."""


def read(obs):
    if not obs.get("batches"):
        return None
    return obs["images"] / obs["batches"]
