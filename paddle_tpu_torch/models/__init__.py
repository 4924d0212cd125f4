"""Model definitions (the BASELINE workloads): ResNet, SE-ResNeXt, VGG,
the MNIST conv net, the stacked LSTM and the seq2seq NMT.

Each module has the benchmark/fluid contract get_model(args) ->
(avg_cost, inference_program, optimizer, train_reader, test_reader,
batch_acc), as in the JAX package: the readers are fluid.batch over the
fluid.dataset readers (synthetic data when DATA_HOME holds no file), and
a DataFeeder turns a batch into a feed. The network functions build
programs as they do in the JAX package."""

from . import machine_translation
from . import mnist
from . import resnet
from . import se_resnext
from . import stacked_dynamic_lstm
from . import vgg
