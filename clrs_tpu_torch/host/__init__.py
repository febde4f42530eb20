"""The JAX package's host layers, loaded under this package's name.

``model/``, ``poly/``, ``compile/``, ``exact/rational.py``, ``utils/hp.py``,
the numpy half of ``dd/core.py`` and ``solver/status.py`` import no JAX at
module level. Only ``clrs_tpu/__init__.py`` does. This package's
``__path__`` is the ``clrs_tpu`` source directory, so
``clrs_tpu_torch.host.compile.sdp`` loads ``clrs_tpu/compile/sdp.py`` as a
submodule of this package: its relative imports resolve here and
``clrs_tpu/__init__.py`` never runs. The source is shared, not copied.

Only those host modules are imported through here, never ``dd/linalg``,
``dd/limb_gemm``, ``dd/expops``, ``solver/step`` or ``solver/ipm`` (they
import JAX); ``tests/test_torch_ops.py`` guards that.
"""

import importlib.util as _ilu

_spec = _ilu.find_spec("clrs_tpu")
if _spec is None or not _spec.submodule_search_locations:
    raise ImportError("clrs_tpu_torch.host needs the clrs_tpu source tree "
                      "beside it (its host layers are shared, not copied)")
__path__ = list(_spec.submodule_search_locations)
