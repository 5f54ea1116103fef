"""
Sensor tags, a copy of ``gordo_tpu/dataset/sensor_tag.py``: a tag has a
``name`` and an optional ``asset``; configs give tags as strings, dicts
or ``[name, asset]`` lists.
"""

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union


@dataclass(frozen=True)
class SensorTag:
    name: str
    asset: Optional[str] = None

    def to_json(self) -> dict:
        out = {"name": self.name}
        if self.asset is not None:
            out["asset"] = self.asset
        return out


class SensorTagNormalizationError(ValueError):
    pass


def normalize_sensor_tag(tag: Union[str, dict, Sequence, SensorTag], asset: Optional[str] = None) -> SensorTag:
    """
    Any config form of a tag as a ``SensorTag``.

    >>> normalize_sensor_tag("TAG-1")
    SensorTag(name='TAG-1', asset=None)
    >>> normalize_sensor_tag(["TAG-1", "plant-a"])
    SensorTag(name='TAG-1', asset='plant-a')
    """
    if isinstance(tag, SensorTag):
        return tag
    if isinstance(tag, str):
        return SensorTag(name=tag, asset=asset)
    if isinstance(tag, dict):
        if "name" not in tag:
            raise SensorTagNormalizationError(f"Tag dict missing 'name': {tag!r}")
        return SensorTag(name=tag["name"], asset=tag.get("asset", asset))
    if isinstance(tag, (list, tuple)):
        if not 1 <= len(tag) <= 2:
            raise SensorTagNormalizationError(f"Tag sequence malformed: {tag!r}")
        return SensorTag(name=tag[0], asset=tag[1] if len(tag) > 1 else asset)
    raise SensorTagNormalizationError(f"Unrecognized tag form: {tag!r}")


def normalize_sensor_tags(tags: Sequence, asset: Optional[str] = None) -> List[SensorTag]:
    return [normalize_sensor_tag(tag, asset=asset) for tag in tags]


def to_list_of_strings(tags: Sequence[Union[str, SensorTag]]) -> List[str]:
    """Tag names as plain strings."""
    return [tag.name if isinstance(tag, SensorTag) else str(tag) for tag in tags]


def unique_tag_names(tags: Sequence) -> dict:
    """Tag name to ``SensorTag``, in order; one name bound to two assets raises."""
    by_name = {}
    for tag in tags:
        normalized = normalize_sensor_tag(tag)
        existing = by_name.get(normalized.name)
        if existing is not None and existing != normalized:
            raise SensorTagNormalizationError(
                f"Tag name {normalized.name!r} bound to conflicting definitions: {existing} vs {normalized}"
            )
        by_name[normalized.name] = normalized
    return by_name
