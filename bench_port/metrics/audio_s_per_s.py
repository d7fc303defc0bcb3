"""Seconds of audio whose features came back to the host, over the whole
window, host to host."""


def read(run):
    v = run.values
    if "audio_s" not in v or not v.get("elapsed_s"):
        return None
    return v["audio_s"] / v["elapsed_s"]
