"""Real samples over the samples handed to the kernel after bucketing and
batch padding (the extractor's ``bucket_len`` of each batch times its
padded rows), over the window, in percent."""


def read(run):
    v = run.values
    if not v.get("kernel_samples"):
        return None
    return 100.0 * v["useful_samples"] / v["kernel_samples"]
