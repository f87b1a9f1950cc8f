"""The photon Avro schemas, as parsed-JSON schema objects.

Port of ``photon_tpu/io/schemas.py`` (a copy: the port imports nothing of the
JAX package).

Parity: reference ⟦photon-avro-schemas/src/main/avro/⟧ (SURVEY.md §2.4):
``TrainingExampleAvro`` (label, optional weight/offset, features as a list of
name/term/value triples, metadata map), ``FeatureAvro``/``NameTermValueAvro``,
``BayesianLinearModelAvro`` (means + optional variances as name/term/value
lists, model class, loss function), ``FeatureSummarizationResultAvro``, and
``ScoringResultAvro`` — byte-compatible with files the reference reads and
writes, so a user can point this framework at existing photon-ml datasets and
model directories.
"""
from __future__ import annotations

NAMESPACE = "com.linkedin.photon.avro.generated"

NAME_TERM_VALUE_AVRO = {
    "type": "record",
    "name": "NameTermValueAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": ["null", "string"], "default": None},
        {"name": "value", "type": "double"},
    ],
}

FEATURE_AVRO = {
    "type": "record",
    "name": "FeatureAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "name", "type": "string"},
        {"name": "term", "type": ["null", "string"], "default": None},
        {"name": "value", "type": "double"},
    ],
}

TRAINING_EXAMPLE_AVRO = {
    "type": "record",
    "name": "TrainingExampleAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "label", "type": "double"},
        {"name": "weight", "type": ["null", "double"], "default": None},
        {"name": "offset", "type": ["null", "double"], "default": None},
        {"name": "features", "type": {"type": "array", "items": FEATURE_AVRO}},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}

BAYESIAN_LINEAR_MODEL_AVRO = {
    "type": "record",
    "name": "BayesianLinearModelAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "modelId", "type": "string"},
        {"name": "modelClass", "type": ["null", "string"], "default": None},
        {"name": "lossFunction", "type": ["null", "string"], "default": None},
        {
            "name": "means",
            "type": {"type": "array", "items": NAME_TERM_VALUE_AVRO},
        },
        {
            "name": "variances",
            "type": ["null", {"type": "array", "items": "NameTermValueAvro"}],
            "default": None,
        },
    ],
}

FEATURE_SUMMARIZATION_RESULT_AVRO = {
    "type": "record",
    "name": "FeatureSummarizationResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "featureName", "type": "string"},
        {"name": "featureTerm", "type": ["null", "string"], "default": None},
        {"name": "metrics", "type": {"type": "map", "values": "double"}},
    ],
}

SCORING_RESULT_AVRO = {
    "type": "record",
    "name": "ScoringResultAvro",
    "namespace": NAMESPACE,
    "fields": [
        {"name": "uid", "type": ["null", "string"], "default": None},
        {"name": "predictionScore", "type": "double"},
        {"name": "label", "type": ["null", "double"], "default": None},
        {
            "name": "metadataMap",
            "type": ["null", {"type": "map", "values": "string"}],
            "default": None,
        },
    ],
}
