"""
``patch_dict``, a copy of ``gordo_tpu/workflow/helpers.py``: paths in the
patch are added or replace existing values; nothing is ever removed.
"""

import copy
from typing import Any, Dict


def patch_dict(original_dict: dict, patch_dictionary: dict) -> dict:
    """
    ``patch_dictionary`` laid over a deep copy of ``original_dict``,
    recursively.

    >>> patch_dict({"highKey": {"lowkey1": 1, "lowkey2": 2}}, {"highKey": {"lowkey1": 10}})
    {'highKey': {'lowkey1': 10, 'lowkey2': 2}}
    >>> patch_dict({"highKey": {"lowkey1": 1}}, {"highKey2": 4})
    {'highKey': {'lowkey1': 1}, 'highKey2': 4}
    """
    result: Dict[str, Any] = copy.deepcopy(original_dict)

    def overlay(base: dict, patch: dict) -> None:
        for key, value in patch.items():
            if key in base and isinstance(base[key], dict) and isinstance(value, dict):
                overlay(base[key], value)
            else:
                base[key] = copy.deepcopy(value)

    overlay(result, patch_dictionary)
    return result
