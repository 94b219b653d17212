"""Model import (counterpart of ``deeplearning4j_tpu.imports``).

Ported: the imported-BERT workload's builders (:mod:`.tf_oracles`), which
emit the graph the JAX package's TF import of its BERT GraphDef yields. Not
ported yet: ``TFGraphMapper`` (it parses a GraphDef with tensorflow),
``KerasModelImport`` and ``OnnxGraphMapper``.
"""

from deeplearning4j_tpu_torch.imports.tf_oracles import (bert_synthetic_batch,
                                                         build_bert_samediff,
                                                         graft_classifier)

__all__ = ["bert_synthetic_batch", "build_bert_samediff", "graft_classifier"]
