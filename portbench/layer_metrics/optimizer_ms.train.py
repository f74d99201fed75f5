"""Device ms a step of the kernels launched inside the trainer's own
``train/optimizer`` annotation (the clip and AdamW), over the traced
steps."""


def read(readings):
    profile = readings.get("profile")
    if profile is None or not profile.units:
        return None
    s = profile.device_s(regions=("train/optimizer",))
    return s / profile.units * 1e3 if s > 0 else None
