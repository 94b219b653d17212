"""BERT (BASELINE config #4's model), counterpart of
``deeplearning4j_tpu/zoo/bert.py`` with the same configuration.

``Bert.base()`` is BERT-base (L=12, H=768, A=12), ``Bert.small()`` a small
preset for tests (L=2, H=128, A=2). The classification variant appends
[CLS] pooling, a tanh pooler and a softmax head (the SST-2 fine-tune shape).
Masks: pass the padding mask as the features mask (``output(x, mask=m)``,
``fit(ids, onehot_labels, mask=m)``); attention reads it as a key-side mask.
``fit`` trains under the zoo's ``Adam(2e-5)``, with attention's backward in
the flash backward kernels on the card and dropout masks drawn there.
"""

from deeplearning4j_tpu_torch.nn import (BertEmbeddingLayer, ClsPoolingLayer, DenseLayer,
                                         InputType, NeuralNetConfiguration, OutputLayer,
                                         TransformerEncoderBlock, TransformerEncoderStack)
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class Bert(ZooModel):
    def __init__(self, vocab_size: int = 30522, d_model: int = 768,
                 n_layers: int = 12, n_heads: int = 12, ffn_size: int = 3072,
                 max_len: int = 512, num_classes: int = 2, seed: int = 123,
                 dropout_rate: float = 0.1, updater=None, stacked: bool = False):
        super().__init__(num_classes=num_classes, seed=seed)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.ffn_size = ffn_size
        self.max_len = max_len
        self.dropout_rate = dropout_rate
        self.updater = updater or Adam(2e-5)
        # one TransformerEncoderStack over layer-stacked parameters in place
        # of n_layers TransformerEncoderBlocks (the same math)
        self.stacked = stacked

    @staticmethod
    def base(num_classes: int = 2, **kw) -> "Bert":
        return Bert(d_model=768, n_layers=12, n_heads=12, ffn_size=3072,
                    num_classes=num_classes, **kw)

    @staticmethod
    def small(num_classes: int = 2, **kw) -> "Bert":
        """BERT-small-ish for tests: L=2, H=128, A=2."""
        kw.setdefault("vocab_size", 1000)
        return Bert(d_model=128, n_layers=2, n_heads=2, ffn_size=256,
                    max_len=128, num_classes=num_classes, **kw)

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .weight_init("xavier")
             .list()
             .layer(BertEmbeddingLayer(
                 vocab_size=self.vocab_size, d_model=self.d_model,
                 max_len=self.max_len, dropout_rate=self.dropout_rate)))
        if self.stacked:
            b.layer(TransformerEncoderStack(
                n_layers=self.n_layers, n_heads=self.n_heads,
                ffn_size=self.ffn_size, dropout_rate=self.dropout_rate))
        else:
            for _ in range(self.n_layers):
                b.layer(TransformerEncoderBlock(
                    n_heads=self.n_heads, ffn_size=self.ffn_size,
                    dropout_rate=self.dropout_rate))
        return (b.layer(ClsPoolingLayer())
                .layer(DenseLayer(n_out=self.d_model, activation="tanh"))  # pooler
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.recurrent(1))  # int token ids (b, t)
                .build())
