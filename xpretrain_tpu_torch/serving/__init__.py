"""Serving: in-process retrieval towers (``towers``) and ``torch.export``
artifacts of them (``artifact``)."""

from xpretrain_tpu_torch.serving.artifact import (
    FORMAT_VERSION,
    RetrievalArtifact,
    export_hdvila_retrieval_towers,
    export_lfvila_retrieval_towers,
    export_retrieval_towers,
    load_artifact,
    save_artifact,
)

__all__ = [
    "FORMAT_VERSION",
    "RetrievalArtifact",
    "export_hdvila_retrieval_towers",
    "export_lfvila_retrieval_towers",
    "export_retrieval_towers",
    "load_artifact",
    "save_artifact",
]
