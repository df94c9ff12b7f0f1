from fastdiff_tpu_torch.vocoders.base import (BaseVocoder, get_vocoder_cls,
                                              register_vocoder)
from fastdiff_tpu_torch.vocoders import gl  # noqa: F401  (registers GL vocoders)
from fastdiff_tpu_torch.vocoders import fastdiff_vocoder  # noqa: F401
from fastdiff_tpu_torch.vocoders import pwg_vocoder  # noqa: F401
