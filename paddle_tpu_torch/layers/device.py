"""Device layers (reference python/paddle/fluid/layers/device.py): the JAX
package's get_places, whose op is ops/control_flow_ops.py's."""

from ..layer_helper import LayerHelper
from .. import unique_name

__all__ = ["get_places"]


def get_places(device_count=None, device_type=None):
    helper = LayerHelper("get_places")
    out_places = helper.create_variable(name=unique_name.generate(helper.name + ".out"))
    attrs = {}
    if device_count is not None:
        attrs["device_count"] = int(device_count)
    if device_type is not None:
        attrs["device_type"] = str(device_type)
    helper.append_op("get_places", {}, {"Out": [out_places]}, attrs)
    return out_places
