"""Message container for instruct/chat tokenization — a verbatim copy of
``ssi_tpu/tokenizer/messages.py`` (``tests/test_torch_tokenizer.py`` holds it equal).

Torchtune-equivalent ``Message`` API surface (ref: ssi/data/sft.py:14-16 imports
``torchtune.data.Message`` and ``validate_messages``) reimplemented standalone so the
SFT pipeline has no torch dependency.
"""

from __future__ import annotations

from typing import Any


class Message:
    """A single conversation turn.

    Args:
        role: One of ``system`` | ``user`` | ``assistant`` | ``ipython``.
        content: Either a plain string or a list of ``{"type": "text", "content": str}``
            items (the only content type supported on the TPU text stack).
        masked: Whether this message's tokens are excluded from the training loss.
        eot: Whether the message ends with end-of-turn (``<|eot_id|>``) rather than
            end-of-message (``<|eom_id|>``).
        ipython: Whether this is a tool-call message (prefixed with the python tag).
    """

    __slots__ = ("role", "content", "masked", "eot", "ipython")

    def __init__(
        self,
        role: str,
        content: str | list[dict[str, Any]],
        masked: bool = False,
        eot: bool = True,
        ipython: bool = False,
    ):
        self.role = role
        if isinstance(content, str):
            content = [{"type": "text", "content": content}]
        self.content = content
        self.masked = masked
        self.eot = eot
        self.ipython = ipython

    @property
    def text_content(self) -> str:
        return "".join(item["content"] for item in self.content if item["type"] == "text")

    def __repr__(self) -> str:
        return f"Message(role={self.role!r}, content={self.text_content!r}, masked={self.masked}, eot={self.eot})"


def validate_messages(messages: list[Message]) -> None:
    """Structural checks on a conversation (ref: torchtune.data._messages.validate_messages).

    Enforces: at least one user+assistant pair, system (if any) only first, no two
    consecutive same-role messages, and conversation does not open with an assistant turn.
    """
    if len(messages) < 2:
        raise ValueError(f"Messages must contain at least a user-assistant pair, got {len(messages)} message(s)")
    last_turn = "assistant"
    for i, message in enumerate(messages):
        if message.role == "assistant" and last_turn != "user":
            raise ValueError(f"Assistant message before expected user message at index {i} in messages")
        if message.role == "user" and last_turn == "user":
            raise ValueError(f"Two consecutive user messages at index {i} and {i - 1} in messages")
        if message.role == "system" and i > 0:
            raise ValueError(f"System message at index {i} in messages, but system messages must come first")
        last_turn = message.role
