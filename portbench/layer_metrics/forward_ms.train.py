"""Device ms a step of the kernels launched inside the trainer's own
``train/forward`` annotation (the forward and the loss), over the traced
steps."""


def read(readings):
    profile = readings.get("profile")
    if profile is None or not profile.units:
        return None
    s = profile.device_s(regions=("train/forward",))
    return s / profile.units * 1e3 if s > 0 else None
