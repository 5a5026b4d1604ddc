"""The hand-written round kernels' share of their roofline in one traced
run: the bytes their launches must move (`perfbench.work.kernel_work`,
each input read once, each output written once) at the HBM peak, over
their device time. Nothing to read where none of them ran."""
from perfbench import peaks
from perfbench.trace import short_name
from perfbench.work import KERNEL_OF, kernel_work


def kernel(name):
    base = short_name(name).split("<", 1)[0].split("::")[-1]
    return KERNEL_OF.get(base)


def read(trace, counts):
    m, n = counts.get("nodes"), counts.get("n")
    ideal, spent = 0.0, 0.0
    for name, s, e in trace.device:
        which = kernel(name)
        if which is None:
            continue
        nnz = counts.get("nnz") if which == "round_update_sparse" else None
        nbytes, _ = kernel_work(which, m, n, nnz=nnz)
        ideal += nbytes / peaks.HBM_BYTES_PER_S
        spent += (e - s) * 1e-6
    if spent <= 0:
        return None
    return 100.0 * ideal / spent
