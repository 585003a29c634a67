"""Machine-checked response schemas for the HTTP endpoints.

A copy of ``vqa_tpu/serving/schemas.py``: plain dict-shape validators with
the field contracts of the reference's Pydantic response models
(reference: api/main.py:46-67; FastAPI is an optional dependency), shared
by the stdlib server's handlers (every success payload is validated before
it leaves the process), the import-gated FastAPI adapter (which delegates
to the same handlers), and the tests.

A validator raises ``SchemaError`` on a wrong shape — in the handlers that
surfaces as the endpoint's standard error payload rather than a silently
malformed response.
"""

from __future__ import annotations

from typing import Any, Dict

Number = (int, float)


class SchemaError(TypeError):
    """A response payload does not match its declared schema."""


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SchemaError(msg)


def _field(payload: Dict[str, Any], name: str, types) -> Any:
    _check(name in payload, f"missing field '{name}'")
    v = payload[name]
    _check(isinstance(v, types), f"field '{name}' is {type(v).__name__}")
    # bool is an int subclass; never accept it where a number is declared
    if types in (Number, int, float) and isinstance(v, bool):
        raise SchemaError(f"field '{name}' is bool")
    return v


def validate_answer_item(item: Dict[str, Any]) -> Dict[str, Any]:
    """{answer: str, probability: float, index: int}
    (reference: api/main.py:46-50)."""
    _check(isinstance(item, dict), "answer item must be a dict")
    _field(item, "answer", str)
    p = _field(item, "probability", Number)
    _check(0.0 <= p <= 1.0, f"probability {p} outside [0, 1]")
    _field(item, "index", int)
    return item


def validate_prediction(payload: Dict[str, Any]) -> Dict[str, Any]:
    """PredictionResponse: {question, answers[], top_answer, confidence,
    success, error|None} (reference: api/main.py:52-59)."""
    _field(payload, "question", str)
    _field(payload, "top_answer", str)
    c = _field(payload, "confidence", Number)
    _check(0.0 <= c <= 1.0, f"confidence {c} outside [0, 1]")
    _field(payload, "success", bool)
    _check(
        payload.get("error") is None or isinstance(payload["error"], str),
        "error must be None or str",
    )
    answers = _field(payload, "answers", list)
    for a in answers:
        validate_answer_item(a)
    if payload["success"]:
        _check(len(answers) > 0, "successful prediction with empty answers")
    return payload


def validate_batch_prediction(payload: Dict[str, Any]) -> Dict[str, Any]:
    """{success: bool, predictions: [PredictionResponse-core...]}
    (reference: api/main.py:61-63)."""
    _field(payload, "success", bool)
    preds = _field(payload, "predictions", list)
    for p in preds:
        _check(isinstance(p, dict), "prediction must be a dict")
        _field(p, "question", str)
        _field(p, "top_answer", str)
        _field(p, "confidence", Number)
        for a in _field(p, "answers", list):
            validate_answer_item(a)
    return payload


def validate_health(payload: Dict[str, Any]) -> Dict[str, Any]:
    """{status: str, model_loaded: bool} (reference: api/main.py:65-67)."""
    _field(payload, "status", str)
    _field(payload, "model_loaded", bool)
    return payload


def validate_model_info(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Superset of the reference's model-info dict
    (reference: api/main.py:138-156)."""
    _field(payload, "device", str)
    _field(payload, "vocab_size", int)
    _field(payload, "num_answers", int)
    _field(payload, "total_parameters", int)
    return payload


def validate_index(payload: Dict[str, Any]) -> Dict[str, Any]:
    _field(payload, "name", str)
    _field(payload, "version", str)
    _field(payload, "endpoints", dict)
    return payload


def validate_attention(payload: Dict[str, Any]) -> Dict[str, Any]:
    """PredictionResponse + {attention: {tokens[], spatial_size,
    maps[L][S][S]}} — the cross-attention visualization endpoint (no
    reference HTTP counterpart; mirrors models/vqa_model.py:341-369)."""
    validate_prediction(payload)
    att = _field(payload, "attention", dict)
    tokens = _field(att, "tokens", list)
    size = _field(att, "spatial_size", int)
    maps = _field(att, "maps", list)
    _check(len(maps) == len(tokens),
           f"{len(maps)} maps for {len(tokens)} tokens")
    for m in maps:
        _check(
            len(m) == size and all(len(row) == size for row in m),
            f"attention map is not {size}x{size}",
        )
    return payload
