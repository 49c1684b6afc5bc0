"""StyleGAN2's layer epilogue: the bytes bound of the ops stretch's units (counts2.py, handed over by the serve2 kind as run.epilogue2_bytes) at the HBM bandwidth over the device time of kernels under stylegan_torch::epilogue* ops (trace.py's epilogue_s)."""


def read(run):
    t, per_unit = run.trace, getattr(run, "epilogue2_bytes", None)
    if not t or not run.peaks or not per_unit or t["epilogue_s"] <= 0:
        return None
    a, b = t["ops_range"]
    return 100.0 * sum(per_unit[a:b]) / run.peaks["hbm"] / t["epilogue_s"]
