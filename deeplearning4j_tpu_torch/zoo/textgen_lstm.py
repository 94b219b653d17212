"""TextGenerationLSTM (reference ``org.deeplearning4j.zoo.model.TextGenerationLSTM``),
counterpart of ``deeplearning4j_tpu/zoo/textgen_lstm.py``: char-RNN language
model, stacked (Graves)LSTM + time-distributed softmax."""

from deeplearning4j_tpu_torch.nn import (GravesLSTM, InputType, LSTM,
                                         NeuralNetConfiguration, RnnOutputLayer)
from deeplearning4j_tpu_torch.train.updaters import RmsProp
from deeplearning4j_tpu_torch.zoo.base import ZooModel


class TextGenerationLSTM(ZooModel):
    def __init__(self, vocab_size: int = 77, seed: int = 123,
                 hidden: int = 256, layers: int = 2, tbptt_length: int = 50,
                 graves: bool = False, updater=None):
        super().__init__(num_classes=vocab_size, seed=seed)
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.layers = layers
        self.tbptt_length = tbptt_length
        self.graves = graves
        self.updater = updater or RmsProp(1e-3)

    def conf(self):
        cell = GravesLSTM if self.graves else LSTM
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater)
             .list())
        for _ in range(self.layers):
            b.layer(cell(n_out=self.hidden, activation="tanh"))
        return (b.layer(RnnOutputLayer(n_out=self.vocab_size, activation="softmax",
                                       loss="mcxent"))
                .set_input_type(InputType.recurrent(self.vocab_size))
                .tbptt_fwd_length(self.tbptt_length)
                .tbptt_back_length(self.tbptt_length)
                .build())
