"""Engine layer: the share of the cells the kernels computed that were
padding, 1 - real / padded, over the window's searches (the program's
exact SearchMetrics counts, cells and padded_cells)."""


def read(rec):
    padded = rec.counters.get("program_padded_cells")
    if not padded:
        return None
    return 100.0 * (1.0 - rec.counters["program_cells"] / padded)
