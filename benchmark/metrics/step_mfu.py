"""The whole step's share of the card's peak: the least time the step's
work needs on the card over the step's measured wall time, summed over
the window's steps.  The least time is the larger of the AM's products
at the float32 peak (the program keeps TF32 off) and the step's bytes at
the HBM bandwidth (``benchmark/peaks.json``).

FLOPs: 2 x the multiply-adds of the AM's products for each frame the
step's inputs need (frames with audio: an idle arena row rides along in
the program but is not counted).  Bytes: the AM's weights once, each
frame's AM input and log-likelihoods once, the search's reads of the
log-likelihoods, its logs (back-pointers and arc ids a stage, the token
snapshot) and, where the run counted them, the state records of the
live tokens entering each frame.  A step: an arena tick (serving), or a
batch from its input to its words (offline, the host traceback in its
time)."""

from benchmark import inputs


def read(data):
    peaks = data.get("peaks")
    if not peaks:
        return None
    cfg = data["config"]
    am = cfg.get("am")
    fpf = inputs.am_flops_per_frame(am) if am else 0
    wbytes = inputs.am_weight_bytes(am) if am else 0
    t0, t1 = data["window"]
    K = data.get("K", min(cfg["search"]["beam_width"],
                          cfg["search"]["max_active"]))
    stages = data.get("stages", 2)
    V = am["num_pdfs"] if am else data["vocab"]
    in_dim = am["feat_dim"] * (2 * am["context"] + 1) if am else 0
    log_bytes = 4 * K * (2 * stages + 2)        # a row-frame's logs
    least = wall = 0.0
    if "ticks" in data:                          # serving: arena ticks
        for a, b, frames, _ in data["ticks"]:
            if a < t0 or b > t1:
                continue
            flops = frames * fpf
            nbytes = wbytes + frames * (4 * (in_dim + 2 * V) + log_bytes)
            least += max(flops / peaks["fp32_flops"],
                         nbytes / peaks["hbm_bytes_per_s"])
            wall += b - a
    else:                                        # offline: batches
        B, lanes = data["batch"], data["lanes"]
        for a, b, _, _, frames, live in data.get("steps", ()):
            if a < t0 or b > t1:
                continue
            rf = B * frames
            flops = rf * fpf
            nbytes = (wbytes + rf * (4 * (in_dim + 2 * V) + log_bytes)
                      + live * lanes * 4)
            if not am:                           # the posteriors, packed
                nbytes += 4 * B * data["frames"] * V
            least += max(flops / peaks["fp32_flops"],
                         nbytes / peaks["hbm_bytes_per_s"])
            wall += b - a
    return 100.0 * least / wall if wall > 0 else None
