"""Language lookup APIs.

The reference packs 4-char codes into a uint32 key and exposes
``findLanguageKeyW/A`` + ``getSupportedLanguages`` (Whisper/Whisper/
Languages.cpp:6-121; Whisper/API/sFullParams.h:115-130). Here languages are
plain strings; ids follow the standard whisper ordering so that the language
*token* for id ``i`` is ``token_sot + 1 + i``.
"""

from __future__ import annotations

from whisper_tpu_torch._language_data import LANGUAGE_TABLE

# code -> (id, name)
LANGUAGES: dict[str, tuple[int, str]] = {
    code: (i, name) for i, (code, name) in enumerate(LANGUAGE_TABLE)
}
_BY_NAME: dict[str, int] = {name: i for i, (_, name) in enumerate(LANGUAGE_TABLE)}


def find_language_id(language: str | None) -> int:
    """Resolve a language code or full name to a whisper language id.

    Returns -1 when unknown (reference lookupLanguageId semantics,
    ContextImpl.cpp:497-507).
    """
    if not language:
        return -1
    key = language.strip().lower()
    if key in LANGUAGES:
        return LANGUAGES[key][0]
    return _BY_NAME.get(key, -1)


def language_name(lang_id: int) -> str | None:
    if 0 <= lang_id < len(LANGUAGE_TABLE):
        return LANGUAGE_TABLE[lang_id][1]
    return None


def language_code(lang_id: int) -> str | None:
    if 0 <= lang_id < len(LANGUAGE_TABLE):
        return LANGUAGE_TABLE[lang_id][0]
    return None


def supported_languages() -> list[tuple[str, str]]:
    """(code, name) pairs in id order (reference getSupportedLanguages)."""
    return list(LANGUAGE_TABLE)
