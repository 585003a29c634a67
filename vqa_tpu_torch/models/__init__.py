"""The VQA model of the port: backbone, text encoder, fusion, answer head,
and the CNN attention modules."""

from vqa_tpu_torch.models.attention_modules import (  # noqa: F401
    AttentionWrapper,
    CBAMBlock,
    SEAttention,
    SelfAttention2D,
    SpatialAttention,
)
from vqa_tpu_torch.models.vqa_model import (  # noqa: F401
    AnswerHead,
    VQAModel,
    count_parameters,
    create_vqa_model,
    forward_logits,
    get_attention_maps,
    predict_topk,
)
