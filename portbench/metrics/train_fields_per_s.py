"""train_fields_per_s: fields trained to the configuration's sweep count,
over the window's seconds (host clock; every call ends synchronised)."""


def read(ctx):
    if ctx.work["kind"] != "train":
        return None
    return sum(it[3] for it in ctx.window["items"]) / ctx.window["seconds"]
