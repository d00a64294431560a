"""Wall ms of ``TorchBeamSearch.advance`` a frame, ended by a device
synchronize: all advances of the window over all their frames."""


def read(data):
    t0, t1 = data["window"]
    steps = [s for s in data.get("steps", ()) if s[0] >= t0 and s[1] <= t1]
    frames = sum(s[4] for s in steps)
    return sum(s[3] - s[2] for s in steps) / frames * 1e3 if frames else None
