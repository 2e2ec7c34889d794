"""Peak device memory of inference above what was held before the model, GiB."""


def read(tr):
    return tr.run.get("peak_gib")
