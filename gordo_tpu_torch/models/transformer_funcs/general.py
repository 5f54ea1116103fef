"""
Named functions that a ``FunctionTransformer`` step of a definition may
name (``gordo_tpu/models/transformer_funcs/general.py``; the reference's
``gordo/machine/model/transformer_funcs/general.py``).
"""


def multiply_by(X, factor):
    """
    Multiply the input by ``factor``.

    >>> import numpy as np
    >>> multiply_by(np.array([1.0, 2.0]), 2).tolist()
    [2.0, 4.0]
    """
    return X * factor
