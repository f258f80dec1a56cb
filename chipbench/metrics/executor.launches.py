"""Model executor: the device operations (kernels, copies, fills) of the
traced slice over its forward calls, one a replica."""


def read(ctx):
    prof = ctx["profile"]
    if not prof:
        return None
    n = sum(1 for name, _, _ in prof["spans"] if name == "executor.forward")
    return prof["n_device_ops"] / n if n and prof["n_device_ops"] else None
