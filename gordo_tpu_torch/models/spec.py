"""
Static model specifications: frozen, hashable data that says what a
served network is.

A copy of ``gordo_tpu/models/spec.py``'s specs: a
:class:`FeedForwardSpec` and an :class:`LSTMSpec` with the
:class:`OptimizerSpec` fields they carry, equal field by field to the JAX
package's, so that one artifact's spec means the same thing to both
packages. Specs are hashable because the fleet store groups members into
one stacked bucket per spec. :class:`Dense` and :class:`Sequential` are
the raw layer-list definition that compiles to a ``FeedForwardSpec``.
"""

from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Tuple, Union


def _freeze_kwargs(kwargs: Optional[Dict[str, Any]]) -> Tuple[Tuple[str, Any], ...]:
    if not kwargs:
        return ()
    return tuple(sorted(kwargs.items()))


@dataclass(frozen=True)
class OptimizerSpec:
    """Optimizer configuration (Keras' Adam defaults). Serving only carries
    it, so a spec compares equal to the one it was trained with."""

    name: str = "Adam"
    learning_rate: float = 0.001
    kwargs: Tuple[Tuple[str, Any], ...] = ()

    @classmethod
    def from_config(
        cls,
        optimizer: Union[str, "OptimizerSpec", None] = "Adam",
        optimizer_kwargs: Optional[Dict[str, Any]] = None,
    ) -> "OptimizerSpec":
        if isinstance(optimizer, OptimizerSpec):
            return optimizer
        optimizer_kwargs = dict(optimizer_kwargs or {})
        lr = optimizer_kwargs.pop(
            "learning_rate", optimizer_kwargs.pop("lr", 0.001)
        )
        return cls(
            name=optimizer or "Adam",
            learning_rate=float(lr),
            kwargs=_freeze_kwargs(optimizer_kwargs),
        )


class ModelSpec:
    """The JSON form shared by the specs: ``to_dict`` writes the JAX
    package's ``ModelSpec.to_dict``, ``from_dict`` reads it back."""

    #: fields read back as tuples of this type
    _TUPLES = {"dims": int, "activations": str, "l1_activity": float}
    #: fields read back as ints
    _INTS = ("n_features", "n_features_out", "lookback_window")

    def to_dict(self) -> Dict[str, Any]:
        """The JSON form, key for key the JAX package's ``to_dict``."""
        out: Dict[str, Any] = {"spec_type": type(self).__name__}
        for f in fields(self):
            value = getattr(self, f.name)
            if isinstance(value, OptimizerSpec):
                value = {
                    "name": value.name,
                    "learning_rate": value.learning_rate,
                    **dict(value.kwargs),
                }
            out[f.name] = value
        return out

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ModelSpec":
        """Inverse of :meth:`to_dict` (also reads the JAX package's form).

        >>> spec = FeedForwardSpec(3, 3, (2,), ("tanh",))
        >>> FeedForwardSpec.from_dict(spec.to_dict()) == spec
        True
        """
        data = dict(data)
        spec_type = data.pop("spec_type", cls.__name__)
        if spec_type != cls.__name__:
            raise ValueError(f"Not a {cls.__name__}: {spec_type!r}")
        optimizer = dict(data.pop("optimizer", None) or {})
        name = optimizer.pop("name", "Adam")
        lr = optimizer.pop("learning_rate", 0.001)
        for key, kind in cls._TUPLES.items():
            if key in data:
                data[key] = tuple(kind(v) for v in data[key])
        for key in cls._INTS:
            if key in data:
                data[key] = int(data[key])
        return cls(optimizer=OptimizerSpec(name, float(lr), _freeze_kwargs(optimizer)), **data)


@dataclass(frozen=True)
class FeedForwardSpec(ModelSpec):
    """
    A feedforward autoencoder: ``dims[i]`` hidden units with
    ``activations[i]``, then an output layer of ``n_features_out`` with
    ``out_activation``. ``l1_activity`` and ``optimizer`` only matter to
    training; they are kept so specs compare equal across packages.
    """

    n_features: int
    n_features_out: int
    dims: Tuple[int, ...]
    activations: Tuple[str, ...]
    out_activation: str = "linear"
    l1_activity: Tuple[float, ...] = ()
    optimizer: OptimizerSpec = field(default_factory=OptimizerSpec)
    loss: str = "mse"
    compute_dtype: str = "float32"
    precision: str = ""

    def __post_init__(self):
        if len(self.dims) != len(self.activations):
            raise ValueError(
                f"dims ({len(self.dims)}) and activations "
                f"({len(self.activations)}) must have equal length"
            )
        if self.l1_activity and len(self.l1_activity) != len(self.dims):
            raise ValueError("l1_activity must match dims length when given")

    def layer_names(self) -> Tuple[Tuple[str, str], ...]:
        """``((param key, activation name), ...)`` in forward order.

        >>> FeedForwardSpec(3, 3, (2,), ("tanh",)).layer_names()
        (('dense_0', 'tanh'), ('out', 'linear'))
        """
        names = tuple(
            (f"dense_{i}", self.activations[i]) for i in range(len(self.dims))
        )
        return names + (("out", self.out_activation),)

    def widths(self) -> Tuple[int, ...]:
        """Input width, every hidden width, output width.

        >>> FeedForwardSpec(3, 4, (2,), ("tanh",)).widths()
        (3, 2, 4)
        """
        return (self.n_features,) + tuple(self.dims) + (self.n_features_out,)


@dataclass(frozen=True)
class LSTMSpec(ModelSpec):
    """
    A stacked LSTM over ``lookback_window`` time steps, many to one: every
    LSTM layer but the last hands its whole hidden sequence on, and a
    dense head reads the last step's hidden state. ``activations[i]``
    drives layer ``i``'s candidate and its cell output, the gates are
    sigmoids (Keras' LSTM). ``optimizer`` only matters to training.
    """

    n_features: int
    n_features_out: int
    lookback_window: int
    dims: Tuple[int, ...]
    activations: Tuple[str, ...]
    out_activation: str = "linear"
    optimizer: OptimizerSpec = field(default_factory=OptimizerSpec)
    loss: str = "mse"
    compute_dtype: str = "float32"
    precision: str = ""

    def __post_init__(self):
        if len(self.dims) != len(self.activations):
            raise ValueError(
                f"dims ({len(self.dims)}) and activations "
                f"({len(self.activations)}) must have equal length"
            )
        if not self.dims:
            raise ValueError("LSTM spec needs at least one layer")

    def layer_names(self) -> Tuple[Tuple[str, str], ...]:
        """``((param key, activation name), ...)`` in forward order.

        >>> LSTMSpec(3, 3, 4, (2,), ("tanh",)).layer_names()
        (('lstm_0', 'tanh'), ('out', 'linear'))
        """
        names = tuple(
            (f"lstm_{i}", self.activations[i]) for i in range(len(self.dims))
        )
        return names + (("out", self.out_activation),)

    def widths(self) -> Tuple[int, ...]:
        """Input width, every hidden width, output width.

        >>> LSTMSpec(3, 4, 4, (2,), ("tanh",)).widths()
        (3, 2, 4)
        """
        return (self.n_features,) + tuple(self.dims) + (self.n_features_out,)


@dataclass
class Dense:
    """One layer of a raw ``Sequential`` definition (Keras' ``Dense``):
    ``units``, ``activation``, ``l1_activity``. ``input_shape`` and
    ``input_dim`` are accepted and ignored: the input width is the data's."""

    units: int
    activation: str = "linear"
    l1_activity: float = 0.0
    input_shape: Optional[Tuple[int, ...]] = None
    input_dim: Optional[int] = None

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {"units": self.units, "activation": self.activation, "l1_activity": self.l1_activity}


class Sequential:
    """A raw layer-list definition (``KerasRawModelRegressor``'s
    ``tensorflow.keras.models.Sequential``), which
    :meth:`compile_spec` turns into a :class:`FeedForwardSpec`: the last
    layer is the head, the others the hidden layers."""

    def __init__(self, layers, optimizer="Adam", optimizer_kwargs=None, loss="mse"):
        self.layers = list(layers)
        self.optimizer = optimizer
        self.optimizer_kwargs = optimizer_kwargs or {}
        self.loss = loss

    def get_params(self, deep: bool = False) -> Dict[str, Any]:
        return {
            "layers": self.layers,
            "optimizer": self.optimizer,
            "optimizer_kwargs": self.optimizer_kwargs,
            "loss": self.loss,
        }

    def compile_spec(self, n_features: int) -> FeedForwardSpec:
        """The :class:`FeedForwardSpec` of the layers for ``n_features``
        inputs (``gordo_tpu/models/spec.py:230-251``); only ``Dense``
        layers, at least one.

        >>> Sequential([Dense(4, "tanh"), Dense(3)]).compile_spec(3).widths()
        (3, 4, 3)
        """
        dense_layers = [layer for layer in self.layers if isinstance(layer, Dense)]
        if len(dense_layers) != len(self.layers):
            raise ValueError(
                "Only Dense layers are supported in raw Sequential specs; got "
                f"{[type(layer).__name__ for layer in self.layers]}"
            )
        if not dense_layers:
            raise ValueError("Sequential spec needs at least one Dense layer")
        hidden, head = dense_layers[:-1], dense_layers[-1]
        return FeedForwardSpec(
            n_features=n_features,
            n_features_out=head.units,
            dims=tuple(layer.units for layer in hidden),
            activations=tuple(layer.activation for layer in hidden),
            out_activation=head.activation,
            l1_activity=tuple(layer.l1_activity for layer in hidden)
            if any(layer.l1_activity for layer in hidden)
            else (),
            optimizer=OptimizerSpec.from_config(self.optimizer, self.optimizer_kwargs),
            loss=self.loss,
        )


def spec_from_dict(data: Dict[str, Any]) -> ModelSpec:
    """The spec a ``to_dict`` form names in its ``spec_type``.

    >>> spec_from_dict(LSTMSpec(3, 3, 4, (2,), ("tanh",)).to_dict()).lookback_window
    4
    """
    kinds = {cls.__name__: cls for cls in (FeedForwardSpec, LSTMSpec)}
    spec_type = data.get("spec_type", "FeedForwardSpec")
    if spec_type not in kinds:
        raise ValueError(f"Unknown spec_type {spec_type!r}; known: {sorted(kinds)}")
    return kinds[spec_type].from_dict(data)
