"""Typed error surface — parity with the reference's rich error helpers
(JuliaGrid src/backend/utility.jl:589-893: checkSlackBus,
errorTypeConversion, errorStatusDevice, errorSlackDefinition,
errorOnePoint/errorSlope, errorTransfer, errorAddDual*, checkVariance,
errorVariance/errorCovariance, errorVoltage/Current/Power, errorOptimal,
errorTemplate*, label guards at utility.jl:151-198).

Every class subclasses the built-in exception the code historically
raised (ValueError / KeyError), so ``except ValueError`` call sites and
tests keep working while users can catch the precise condition.
"""

from __future__ import annotations


class JuliaGridError(Exception):
    """Base class of every framework-raised error."""


class SlackBusError(JuliaGridError, ValueError):
    """The slack bus is missing or invalid (reference checkSlackBus)."""


class SlackDefinitionError(JuliaGridError, ValueError):
    """No in-service generator bus exists to carry the slack
    (reference errorSlackDefinition)."""


class LabelError(JuliaGridError, KeyError):
    """A label does not exist, is not unique, or has an invalid type
    (reference utility.jl:161-198)."""

    def __str__(self):  # KeyError quotes its arg; keep the message plain
        return self.args[0] if self.args else ""


class ReuseError(JuliaGridError, ValueError):
    """An analysis cannot be reused because the model structure moved
    past its captured signature (reference errorTypeConversion:
    "The power flow model cannot be reused...")."""


class StatusCountError(JuliaGridError, ValueError):
    """The requested in/out-of-service count exceeds the available
    devices (reference errorStatusDevice)."""


class DeviceStatusError(JuliaGridError, ValueError):
    """A device status is not 0/1 (reference checkStatus)."""


class VarianceError(JuliaGridError, ValueError):
    """A measurement variance is zero/negative, or a correlated PMU
    covariance is invalid (reference checkVariance, errorVariance,
    errorCovariance)."""


class CostError(JuliaGridError, ValueError):
    """A generator cost definition is invalid: wrong model tag, a
    one-point piecewise curve, or an infinite slope (reference
    errorAssignCost, errorOnePoint, errorSlope)."""


class TransferError(JuliaGridError, ValueError):
    """State arrays could not be transferred between analyses because of
    mismatched sizes (reference errorTransfer / DimensionMismatch)."""


class DualAssignmentError(JuliaGridError, ValueError):
    """A dual cannot be assigned: the constraint does not exist or the
    keywords are wrong (reference errorAddDualValid/errorAddDualKeyword)."""


class MissingResultsError(JuliaGridError, ValueError):
    """Voltage/current/power results are missing — run the analysis or
    postprocessing first (reference errorVoltage/errorCurrent/errorPower)."""


class MissingDataError(JuliaGridError, ValueError):
    """A required data section is absent from the input file (reference
    load-time guards: "The bus data is missing." etc.)."""


class TemplateError(JuliaGridError, ValueError):
    """A template/macro keyword or label-template symbol is illegal
    (reference errorTemplateSymbol/errorTemplateKeyword)."""


class MethodError_(JuliaGridError, ValueError):
    """The requested method/option combination is unsupported (e.g. a
    correlated precision matrix on the orthogonal/BBD paths, reference
    acStateEstimation.jl:47-49)."""
