"""Models of the port: the TransformerLM (its train path dense or MoE, on
one card or over an fsdp x tp mesh, and its KV-cache decode path),
`generate()`, the MNIST ConvNet, the CIFAR ResNets with SyncBatchNorm,
BERT for sequence classification, and their flax converters."""

from .bert import (  # noqa: F401
    BertBlock,
    BertConfig,
    BertEncoder,
    BertForSequenceClassification,
    BertSelfAttention,
    bert_sharding_rules,
)
from .convert import (  # noqa: F401
    bert_from_flax,
    bert_to_flax,
    cache_from_flax,
    cache_to_flax,
    convnet_from_flax,
    from_flax,
    resnet_from_flax,
    resnet_to_flax,
    to_flax,
)
from .generate import generate, init_cache, sample_logits  # noqa: F401
from .convnet import ConvNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock,
    Bottleneck,
    ResNet,
    ResNet18,
    ResNet34,
    ResNet50,
    convert_sync_batchnorm,
)
from .transformer import (  # noqa: F401
    TransformerConfig,
    TransformerLM,
    sharding_rules as transformer_sharding_rules,
)
