"""Distance tests per call made by walk lanes whose point lies outside
every dense cell: the program's ``traversal_loose_evals_total``, summed
over phases and engines. DenseBox cannot shortcut these walks."""
from bench import spans


def read(ctx):
    return spans.count_per_unit(ctx, "traversal_loose_evals_total")
