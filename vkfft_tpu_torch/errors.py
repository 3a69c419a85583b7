"""Error taxonomy — analog of the ``VkFFTResult`` enum + string mapper
(``vkFFT_Structs/vkFFT_Structs.h:380-477`` and ``getVkFFTErrorString``
``:479-700``).  The reference's fail-fast error-code discipline becomes a
small exception hierarchy; codes are preserved for CLI parity."""
from __future__ import annotations

import enum


class FFTResult(enum.IntEnum):
    SUCCESS = 0
    ERROR_INVALID_SHAPE = 1001           # VKFFT_ERROR_INVALID_PHYSICAL_DEVICE-class
    ERROR_UNSUPPORTED_LENGTH = 2002      # VKFFT_ERROR_UNSUPPORTED_FFT_LENGTH
    ERROR_UNSUPPORTED_RADIX = 2003
    ERROR_INVALID_CONFIG = 3001          # EMPTY_* config errors (:389-440)
    ERROR_UNSUPPORTED_COMBINATION = 4001
    ERROR_PLAN_NOT_INITIALIZED = 5001
    ERROR_DEVICE = 6001


class FFTError(Exception):
    """Base error; carries an FFTResult code like every reference routine's
    return value."""

    code = FFTResult.ERROR_INVALID_CONFIG

    def __init__(self, msg: str, code: FFTResult | None = None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class UnsupportedLengthError(FFTError):
    code = FFTResult.ERROR_UNSUPPORTED_LENGTH


class InvalidConfigError(FFTError):
    code = FFTResult.ERROR_INVALID_CONFIG


def error_string(code: FFTResult) -> str:
    """``getVkFFTErrorString`` analog."""
    return code.name
