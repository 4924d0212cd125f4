"""Op kernels on torch. Importing this package registers every kernel
the port carries (the training slices: ResNet, SE-ResNeXt, VGG and the
MNIST conv net with Momentum or Adam, the MLP, the sequence family —
embedding, sequence ops, LSTM/GRU and the attention decoder of the
stacked-LSTM and NMT models — the fused bucket updates, and the
collectives of data parallelism), the single-device op tail (matmul, the
reductions, the tensor ops, comparisons and logic, the dense losses and
every optimizer rule), the structured losses (CTC, CRF, NCE, hierarchical
sigmoid), the metrics, the rest of the nn ops, the host file IO ops of
fluid.io, the reader ops (readers held in the scope, `read`), control
flow (while, conditional blocks, tensor arrays, rank tables, the
recurrent ops), beam search, the CSP ops (channels, go, select), the parameter server's
RPC and distributed-table ops, and detection (SSD's priors, matching,
mining and NMS, VOC mAP, roi_pool)."""

from . import util
from . import tensor_ops
from . import math_ops
from . import control_flow_ops
from . import beam_search_ops
from . import activation_ops
from . import nn_ops
from . import metric_ops
from . import optimizer_ops
from . import fused_ops
from . import sparse_ops
from . import sequence_ops
from . import rnn_ops
from . import loss_ops
from . import collective_ops
from . import io_ops
from . import reader_ops
from . import concurrency_ops
from . import rpc_ops
from . import detection_ops
