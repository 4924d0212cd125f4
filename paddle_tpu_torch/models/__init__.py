"""Model definitions (the BASELINE workloads): ResNet, SE-ResNeXt, VGG,
the MNIST conv net, the stacked LSTM and the seq2seq NMT.

Each module has the benchmark/fluid contract get_model(args) ->
(avg_cost, inference_program, optimizer, train_reader, test_reader,
batch_acc), whose readers need the input path (fluid.dataset,
fluid.reader, fluid.batch) that the port does not have yet: get_model
raises `input_path_missing`. The network functions build programs as
they do in the JAX package."""


def input_path_missing(module):
    return NotImplementedError(
        f"paddle_tpu_torch.models.{module}.get_model returns the "
        f"benchmark's readers, built from fluid.dataset, fluid.reader and "
        f"fluid.batch, which the port does not have yet: they come with "
        f"the input-path slice (datapipe, reader, dataset; ROADMAP queue 1 "
        f"item 6). Build the network with the module's network function "
        f"and feed arrays to Executor.run.")


from . import machine_translation  # noqa: E402
from . import mnist  # noqa: E402
from . import resnet  # noqa: E402
from . import se_resnext  # noqa: E402
from . import stacked_dynamic_lstm  # noqa: E402
from . import vgg  # noqa: E402
