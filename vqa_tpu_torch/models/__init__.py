"""The VQA model of the port: backbone, text encoder, fusion, answer head."""

from vqa_tpu_torch.models.vqa_model import (  # noqa: F401
    AnswerHead,
    VQAModel,
    count_parameters,
    create_vqa_model,
    forward_logits,
    get_attention_maps,
    predict_topk,
)
