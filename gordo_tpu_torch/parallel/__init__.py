"""Fleet helpers: the fleet trainer and build, the build journal, the
process mesh (``mesh.py``) and the time-axis ring predict
(``sequence.py``), under the JAX package's names
(``gordo_tpu/parallel/__init__.py``)."""

from .mesh import DATA_AXIS, MODEL_AXIS, initialize_backend, make_mesh, model_data_sharding, model_sharding
from .sequence import ring_windowed_anomaly_scores, ring_windowed_predict

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "initialize_backend",
    "make_mesh",
    "model_data_sharding",
    "model_sharding",
    "ring_windowed_anomaly_scores",
    "ring_windowed_predict",
]
