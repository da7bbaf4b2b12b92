"""Tagged-union config system.

The port's own copy of ``rag_arc_tpu/framework/config.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Capability parity with the reference's ``framework/config.py:11-88``: every
concrete config subclass must declare a ``type: Literal["TAG"] = "TAG"``
discriminator (enforced at class-definition time), nested configs compose
via ``Annotated[A | B, Field(discriminator="type")]``, and ``build()``
instantiates the module the config describes.

Design departure from the reference: configs may declare the class they
build via ``target()`` instead of overriding ``build`` — most configs are
then pure data. The discriminator machinery is what makes a JSON pipeline
spec (see ``rag_arc_tpu_torch.serving``) assemble an entire retrieval engine.
"""

from __future__ import annotations

import typing
from typing import Any, Literal

from pydantic import BaseModel, ConfigDict


class AbstractConfig(BaseModel):
    """Base class for all module configs.

    Subclasses must either set class attribute ``abstract = True`` (for
    intermediate bases) or declare::

        type: Literal["MY_TAG"] = "MY_TAG"

    The tag doubles as the pydantic discriminator for config unions.
    """

    model_config = ConfigDict(extra="forbid")

    abstract: typing.ClassVar[bool] = True

    @classmethod
    def __pydantic_init_subclass__(cls, **kwargs: Any) -> None:
        super().__pydantic_init_subclass__(**kwargs)
        # Reset the flag unless the subclass itself re-declared it.
        if "abstract" not in cls.__dict__:
            cls.abstract = False
        if cls.abstract:
            return
        fld = cls.model_fields.get("type")
        if fld is None:
            raise TypeError(
                f"{cls.__name__} must declare a `type: Literal[...]` tag field "
                "(or set `abstract = True`)"
            )
        origin = typing.get_origin(fld.annotation)
        literals = typing.get_args(fld.annotation)
        if origin is not Literal or len(literals) != 1 or not isinstance(
            literals[0], str
        ):
            raise TypeError(
                f"{cls.__name__}.type must be annotated Literal[\"TAG\"] with a "
                f"single string tag, got {fld.annotation!r}"
            )
        if fld.default != literals[0]:
            raise TypeError(
                f"{cls.__name__}.type default ({fld.default!r}) must equal its "
                f"Literal tag ({literals[0]!r})"
            )

    # -- building ---------------------------------------------------------

    def target(self) -> Any:
        """Return the class this config builds. Override this *or* build()."""
        raise NotImplementedError(
            f"{type(self).__name__} must implement target() or override build()"
        )

    def build(self, **overrides: Any) -> Any:
        """Instantiate the module described by this config.

        Default behavior: ``self.target()(config=self, **overrides)`` if the
        target accepts a ``config`` kwarg, else ``self.target()(**fields)``
        where fields are the config's data minus the tag.
        """
        target = self.target()
        try:
            return target(config=self, **overrides)
        except TypeError:
            data = self.model_dump(exclude={"type"})
            data.update(overrides)
            return target(**data)

    @property
    def tag(self) -> str:
        return getattr(self, "type", type(self).__name__)
