"""Mean milliseconds of the next batch's read and upload dispatch over the
window's steps (``train_unet(profile=)``'s ``load_s``, a program span)."""


def read(run):
    loads = run.get("load_s") if run["kind"] == "train" else None
    if not loads:
        return None
    return sum(loads) / len(loads) * 1e3
